"""Synthetic token data (counterpart of ``repro.data``)."""

from repro_torch.data.pipeline import (  # noqa: F401
    DataCursor,
    SyntheticTokens,
    make_global_batch,
)
