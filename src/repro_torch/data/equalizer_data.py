"""Equalizer data pipeline: channel simulation on the card feeding training.

Port of `repro.data.equalizer_data`. The channel simulators are PyTorch
functions of a `torch.Generator`, so a batch of frames is synthesized on
the device in one call (no Python loop per row, no disk in the loop).
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import torch

from ..channels import imdd, proakis
from ..device import DeviceLike, resolve_device


def channel_fn(kind: str, cfg=None, device: DeviceLike = "cuda") -> Callable:
    """Uniform (generator, n_syms, batch=None) → (rx_waveform, tx_symbols)
    interface; ``generator`` must live on ``device``."""
    dev = resolve_device(device)
    if kind == "imdd":
        ccfg = cfg or imdd.IMDDConfig()
        sim = imdd.simulate
    elif kind == "proakis":
        ccfg = cfg or proakis.ProakisConfig()
        sim = proakis.simulate
    else:
        raise ValueError(kind)

    def fn(generator: torch.Generator, n_syms: int,
           batch: Optional[int] = None):
        return sim(generator, ccfg, n_syms, batch=batch, device=dev)
    return fn


def frames(generator: torch.Generator, fn: Callable, batch: int, n_syms: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(batch, n_syms·N_os) waveforms + (batch, n_syms) symbols."""
    return fn(generator, n_syms, batch=batch)


def stream(generator: torch.Generator, kind: str, batch: int, n_syms: int,
           cfg=None, device: DeviceLike = "cuda"
           ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    fn = channel_fn(kind, cfg, device)
    while True:
        yield frames(generator, fn, batch, n_syms)
