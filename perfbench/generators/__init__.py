"""Traffic generators, one module a kind of traffic, found by the name
that a mix (``perfbench/traffic/<mix>.json``) gives under ``generator``."""
