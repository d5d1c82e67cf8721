"""Entry points of the port: ``train`` trains a model, ``serve`` drives
the batched ACAR engine."""
