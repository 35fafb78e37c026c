from pinot_tpu_torch.io.fs import LocalFS, MemFS, PinotFS, get_fs, register_fs
from pinot_tpu_torch.io.readers import (
    CSVRecordReader,
    JSONRecordReader,
    RecordReader,
    open_record_reader,
)
from pinot_tpu_torch.io.batch import SegmentGenerationJobSpec, run_segment_generation_job

__all__ = [
    "PinotFS",
    "LocalFS",
    "MemFS",
    "get_fs",
    "register_fs",
    "RecordReader",
    "CSVRecordReader",
    "JSONRecordReader",
    "open_record_reader",
    "SegmentGenerationJobSpec",
    "run_segment_generation_job",
]
