"""Runnable training tasks (``python -m columnflow_torch.tasks.wta``)."""
