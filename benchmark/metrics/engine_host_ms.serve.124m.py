"""``engine_host_ms.serve`` of the 124M serving cell: a metric of its
own, which moves that cell's own ``serve_tokens_per_s.124m``."""

from benchmark.harness.spec import reader

read = reader("engine_host_ms.serve")
