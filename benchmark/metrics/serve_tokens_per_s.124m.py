"""``serve_tokens_per_s`` of the 124M serving cell, whose tokens/s the host paces
and spreads more than the XL cell's: a metric of its own, so that it
has a bound of its own in ``BENCHMARK.json``."""

from benchmark.harness.spec import reader

read = reader("serve_tokens_per_s")
