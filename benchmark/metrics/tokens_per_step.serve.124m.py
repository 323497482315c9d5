"""``tokens_per_step.serve`` of the 124M serving cell, whose tokens/s the host paces
and spreads more than the XL cell's: a metric of its own, which moves
that cell's own ``serve_tokens_per_s.124m``."""

from benchmark.harness.spec import reader

read = reader("tokens_per_step.serve")
