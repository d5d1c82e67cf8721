"""The plain reference that decides ``correct``: plain PyTorch over the
benchmark's own weights and inputs, importing nothing of the program
(neither ``repro_torch`` nor the JAX package).

``dense.py`` and ``mamba.py`` score a served sequence in float32, with
TF32 off, layer by layer so it fits beside the weights; with
``precision="fp8"`` they compute every weight product from e4m3 codes
instead, the control that a lower precision must fail. ``acar.py``
replays what the host makes of the tokens: text, answers, sigma, the
forced route and the judge.
"""
