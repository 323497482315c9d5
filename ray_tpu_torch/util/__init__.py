"""Host utilities (counterpart of ``ray_tpu.util``): the checkpoint
on-disk format (``checkpoint_fs``)."""
