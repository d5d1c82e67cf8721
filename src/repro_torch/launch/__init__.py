"""Entry points of the port: ``serve`` drives the batched ACAR engine."""
