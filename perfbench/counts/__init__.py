"""Operation and byte counts of the port's kernels and models, and the
peaks of the card they are held against. Each kernel's count is a file
of its own, named after the kernel's wrapper in
``repro_torch.kernels.ops``; ``model.py`` gives a model's FLOPs per
token. Counts read shapes and dtypes only: each input byte once, each
output byte once, whatever a kernel re-reads."""
