"""Host utilities (counterpart of ``ray_tpu.util``): the checkpoint
on-disk format (``checkpoint_fs``, ``flax_msgpack``) and the measurement
plane (``metrics``, ``goodput``, ``spans``, ``tracing``, ``reqtrace``,
``timeline``, ``flight_recorder``, ``telemetry``, ``xprof``), and the
feeder-thread ``prefetch``."""
