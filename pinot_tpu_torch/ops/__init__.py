from pinot_tpu_torch.ops.groupby import grouped_multi_sum, grouped_multi_sum_plain

__all__ = ["grouped_multi_sum", "grouped_multi_sum_plain"]
