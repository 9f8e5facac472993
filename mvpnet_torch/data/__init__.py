"""Host data path: synthetic scenes, native grid index, view selection,
chunk building, the chunk dataset and its device prefetcher."""
