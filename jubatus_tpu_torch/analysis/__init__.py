"""Correctness tooling of the port: the runtime lock-order detector
(lockgraph.py).  The JAX package's invariant linter is ROADMAP Queue 1
item 7."""
