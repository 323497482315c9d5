"""Collective group backends (counterpart of
``ray_tpu.collective.collective_group``)."""
