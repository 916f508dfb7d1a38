"""Data and tensor parallelism over ``torch.distributed`` (port of
``vct_tpu/parallel``)."""
