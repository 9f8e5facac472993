"""Multi-device layer of the port over ``torch.distributed``: the (data,
space) mesh (``mesh``), process-group bootstrap (``bootstrap``), ring kNN
fusion over the space axis (``fusion``) and space-sharded training
(``train_sp``)."""
