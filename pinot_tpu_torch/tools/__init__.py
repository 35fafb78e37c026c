"""Operator tools: the admin CLI (`python -m pinot_tpu_torch.tools.admin`)."""
