"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu's compute stack.

The JAX package ``ray_tpu`` is the reference; this package keeps its
module paths and public names (``ops.flash_attention``,
``models.gpt2``, ``models.llama``, ``train.train_step``, ``llm``) so
each counterpart is easy to find.  It imports ``torch`` and numpy only: nothing of ``jax`` and
nothing of ``ray_tpu``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see ``device.py``).  On the card, attention runs
through hand-written Hopper kernels (``csrc/flash_{fwd,dkv,dq}.cu``,
built at first use by ``ops/_kernels.py``); on the CPU the same
functions use their plain PyTorch versions.

The package import is kept light: submodules load on demand.
"""

__all__ = ["collective", "device", "dryrun", "llm", "models", "ops",
           "parallel", "train", "util"]
