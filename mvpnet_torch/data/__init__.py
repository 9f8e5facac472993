"""Host data path: synthetic scenes, native grid index, view selection,
chunk building."""
