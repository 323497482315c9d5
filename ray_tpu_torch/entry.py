"""Single-card forward check: counterpart of ``__graft_entry__.entry()``.

``entry(device=None)`` returns ``(fn, args)``: the GPT-2 forward of the
JAX entry's configuration (vocab 8192, 4 layers, 8 heads, d_model 512,
d_ff 2048, max_seq 256, bf16 activations over float32 parameters, dense
attention, no remat), initialised from seed 0, and its example tokens
``[2, 128]``.  ``fn(*args)`` gives the logits ``[2, 128, 8192]``.  The
model's parameters take no gradient: this is the inference entry.
``device=None`` is the card (``resolve_device``).
"""

from __future__ import annotations

import torch

from .device import resolve_device
from .models.gpt2 import GPT2Config, gpt2_init

ENTRY_CONFIG = GPT2Config(vocab_size=8192, n_layer=4, n_head=8, d_model=512,
                          d_ff=2048, max_seq=256, remat=False)


def entry(device=None):
    """Returns (fn, example_args): the GPT-2 forward and its tokens."""
    device = resolve_device(device)
    model = gpt2_init(ENTRY_CONFIG, device=device).requires_grad_(False)
    tokens = torch.zeros((2, 128), dtype=torch.long, device=device)
    return model, (tokens,)
