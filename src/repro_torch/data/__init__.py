"""Data: equalizer frames (port of `repro.data.equalizer_data`) and the LM
token pipeline (port of `repro.data.pipeline`)."""
from .equalizer_data import channel_fn, frames, stream
from .pipeline import PipelineConfig, TokenSource, lm_batches

__all__ = ["PipelineConfig", "TokenSource", "channel_fn", "frames",
           "lm_batches", "stream"]
