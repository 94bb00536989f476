"""Synthetic token data (counterpart of ``repro.data``)."""

from repro_torch.data.pipeline import DataCursor, SyntheticTokens  # noqa: F401
