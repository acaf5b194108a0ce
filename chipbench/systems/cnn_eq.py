"""The CNN equalizer under test: the program's two deployed entries.

Built from a configuration file (topology, backend, formats, channel) and a
traffic file (the entry and the batch's shape), with weights and
waveforms made on the device from the seed:

  * "stream": one link's waveform through
    `repro_torch.core.stream_partition.partitioned_apply` on an
    `EqualizerEngine`: split over N_i instances with the paper's overlap,
    one engine call, the merge;
  * "rows": many independent records (rows) in one launch. With one
    head, every row through its `EqualizerEngine`; with ``heads`` > 1,
    row r through head r // rows_per_head's own weights, stacked per row
    by `repro_torch.core.engine.stacked_engine_fn`.

Draws, in this order from one generator: the heads' raw parameters (He
uniform conv weights, zero conv biases, BN scale, shift and running
statistics, each a few large calls), then the ring of input batches. The
program gets the raw parameters and the formats and folds and quantizes
them itself; the reference (`chipbench.references.cnn_eq`) does the same
from the same raw parameters.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from chipbench import channels, yardstick
from chipbench.harness import quantile
from chipbench.references import cnn_eq as ref


def draw_raw(gen: torch.Generator, cnn: dict, init: dict,
             heads: int) -> dict:
    """Raw parameters of ``heads`` equalizers, leading dim H."""
    dev = gen.device

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    raw = {"w": [], "b": [], "gamma": [], "beta": [], "mean": [], "var": []}
    dims = yardstick.layers(cnn)
    for i, (c_out, c_in, k, _) in enumerate(dims):
        bound = math.sqrt(6.0 / (c_in * k))            # He uniform
        raw["w"].append(uniform((heads, c_out, c_in, k), -bound, bound))
        raw["b"].append(torch.zeros((heads, c_out), device=dev))
        if i < len(dims) - 1:
            raw["gamma"].append(uniform((heads, c_out), *init["bn_gamma"]))
            raw["beta"].append(uniform((heads, c_out), *init["bn_beta"]))
            raw["mean"].append(uniform((heads, c_out), *init["bn_mean"]))
            raw["var"].append(uniform((heads, c_out), *init["bn_var"]))
    return raw


class _Probe:
    """Stands in for the engine callable and records each call's input
    shape and row stride and output size; the traced window only."""

    def __init__(self, fn: Callable, device):
        self.fn, self.device, self.calls = fn, device, []

    def __call__(self, x):
        y = self.fn(x)
        self.calls.append({"rows": int(x.shape[0]), "width": int(x.shape[1]),
                           "row_stride": int(x.stride(0)),
                           "out": int(y.numel())})
        return y


class System:
    """One cell's program, inputs and reference, made from ``seed``."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device):
        self.config, self.traffic, self.device = config, traffic, device
        self.cnn = config["cnn"]
        self.strides = [s for *_, s in yardstick.layers(self.cnn)]
        self.entry = traffic["entry"]
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        t = traffic
        if self.entry == "stream":
            heads, frames = 1, t["instances"] * t["instance_symbols"]
            if frames % t["frame_symbols"]:
                raise ValueError("the stream must be whole frames")
            frames //= t["frame_symbols"]
            row_syms = t["frame_symbols"]
        elif self.entry == "rows":
            heads, frames = t["heads"], t["heads"] * t["rows_per_head"]
            row_syms = t["row_symbols"]
        else:
            raise ValueError(f"unknown entry {self.entry!r}")
        self.heads = heads
        self.raw = draw_raw(gen, self.cnn, config["init"], heads)
        self.inputs = []
        for _ in range(t["ring"]):
            w = channels.waveforms(gen, config["channel"], frames, row_syms)
            self.inputs.append(w.reshape(-1) if self.entry == "stream"
                               else w)
        self.kept_symbols = self.inputs[0].numel() // self.cnn["n_os"]
        self.step = self._build()

    # -- the program ---------------------------------------------------------

    def _engines(self):
        from repro_torch.core.engine import EqualizerEngine
        from repro_torch.core.equalizer import CNNEqConfig, fold_bn

        c = self.cnn
        self.cfg = CNNEqConfig(layers=c["layers"], kernel=c["kernel"],
                               channels=c["channels"],
                               v_parallel=c["v_parallel"], n_os=c["n_os"],
                               levels=c["levels"])
        fmts = self.config.get("formats")
        fmts = tuple(tuple(f) for f in fmts) if fmts else None
        n = c["layers"]
        engines = []
        for h in range(self.heads):
            params = {"conv": [{"w": self.raw["w"][i][h],
                                "b": self.raw["b"][i][h]} for i in range(n)],
                      "bn": [{"scale": self.raw["gamma"][i][h],
                              "bias": self.raw["beta"][i][h]}
                             for i in range(n - 1)]}
            state = {"bn": [{"mean": self.raw["mean"][i][h],
                             "var": self.raw["var"][i][h]}
                            for i in range(n - 1)]}
            eng = EqualizerEngine.from_folded(
                fold_bn(params, state, self.cfg), self.cfg,
                backend=self.config["backend"], formats=fmts,
                device=self.device)
            if eng.backend != self.config["backend"]:
                raise RuntimeError(f"engine deployed {eng.backend}, the "
                                   f"configuration states "
                                   f"{self.config['backend']}")
            engines.append(eng)
        return engines

    def _build(self) -> Callable:
        engines = self._engines()
        if self.entry == "stream":
            from repro_torch.core.stream_partition import partitioned_apply
            eng, n_inst, cfg = engines[0], self.traffic["instances"], self.cfg
            self._callee = eng
            return lambda x: partitioned_apply(eng, x, n_inst, cfg)
        if self.heads == 1:
            self._callee = engines[0]
            return self._callee
        from repro_torch.core.engine import stacked_engine_fn
        per = self.traffic["rows_per_head"]
        self._callee = stacked_engine_fn(
            [engines[r // per] for r in range(self.heads * per)])
        return self._callee

    def call(self, i: int) -> torch.Tensor:
        """Batch i: the program's entry on input i mod ring."""
        return self.step(self.inputs[i % len(self.inputs)])

    def end_to_end(self, win: dict) -> dict:
        """The cell's end-to-end numbers from the untraced window: kept
        symbols a second, in millions, and the 95th percentile of the
        batches' latencies."""
        return {"eq_sym_per_s":
                win["batches"] * self.kept_symbols / win["seconds"] / 1e6,
                "eq_latency_p95_ms": quantile(win["latency_ms"], 0.95)}

    def probe(self) -> list:
        """Route the entry's engine calls through a recorder; returns the
        list it fills."""
        probe = _Probe(self._callee, self.device)
        if self.entry == "stream":
            from repro_torch.core.stream_partition import partitioned_apply
            n_inst, cfg = self.traffic["instances"], self.cfg
            self.step = lambda x: partitioned_apply(probe, x, n_inst, cfg)
        else:
            self.step = probe
        return probe.calls

    def reset_launch_counts(self) -> None:
        from repro_torch.kernels.cnn_eq import cnn_eq as kern
        kern.reset_launch_counts()

    def launch_summary(self, batches: int) -> str:
        """The cnn_eq kernels' launches since the reset, and per batch."""
        from repro_torch.kernels.cnn_eq import cnn_eq as kern
        per = {k: v / batches for k, v in kern.INSTANCE_LAUNCHES.items()}
        return (f"cnn_eq launches over {batches} traced batches: "
                f"{dict(kern.LAUNCHES)} {dict(kern.INSTANCE_LAUNCHES)}; "
                f"per batch rb {per['rb']:g}, generic {per['generic']:g}")

    def release(self) -> None:
        """Drop the program's state before the reference runs."""
        self.step = self._callee = None

    # -- the reference ---------------------------------------------------------

    def datapath(self) -> dict:
        if self.config["backend"] == "fused_int8":
            return {"kind": "int", "formats": self.config["formats"]}
        if self.config["backend"] == "fused_bf16":
            return {"kind": "float", "operand": "bfloat16"}
        raise ValueError(f"no reference datapath for "
                         f"{self.config['backend']}")

    def reference(self, i: int, datapath: dict) -> torch.Tensor:
        """What batch i must give, in the program's output layout."""
        layers = ref.fold(self.raw)
        x = self.inputs[i % len(self.inputs)]
        if self.entry == "stream":
            return ref.equalize_stream(x, layers, self.strides, datapath)
        heads = torch.arange(x.shape[0], device=x.device) \
            // self.traffic["rows_per_head"]
        return ref.equalize_rows(x, layers, self.strides, datapath, heads)
