from repro_torch.data.tasks import Task

__all__ = ["Task"]
