"""Checkpointing of the port: atomic, async save / restore in the
reference's on-disk format."""

from repro_torch.checkpoint.checkpointer import (  # noqa: F401
    Checkpointer,
    load_tree,
    save_tree,
)
