"""Sublayer kinds, one module each: the leaves the benchmark draws, the
float32 reference forward and the work a call needs.  A configuration
names its kinds in ``model.layer_kinds``; a new kind is a new module."""
