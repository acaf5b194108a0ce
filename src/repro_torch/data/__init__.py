"""Equalizer data (port of `repro.data.equalizer_data`). The LM pipeline
(`repro.data.pipeline`) comes with the LM slice."""
from .equalizer_data import channel_fn, frames, stream

__all__ = ["channel_fn", "frames", "stream"]
