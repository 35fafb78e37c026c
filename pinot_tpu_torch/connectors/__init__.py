from pinot_tpu_torch.connectors.dataframe import read_table, read_table_via_servers, write_table

__all__ = ["read_table", "read_table_via_servers", "write_table"]
