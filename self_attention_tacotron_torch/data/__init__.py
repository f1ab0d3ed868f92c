"""Data layer: record schemas, input pipeline, corpus recipes, factory."""

from self_attention_tacotron_torch.data.dataset import (
    SourceData,
    TargetData,
    TacotronDataset,
    make_done_targets,
    pad_to_multiple,
    read_selected_list,
    write_source_tfrecord,
    write_target_tfrecord,
)

__all__ = [
    "SourceData",
    "TargetData",
    "TacotronDataset",
    "make_done_targets",
    "pad_to_multiple",
    "read_selected_list",
    "write_source_tfrecord",
    "write_target_tfrecord",
]
