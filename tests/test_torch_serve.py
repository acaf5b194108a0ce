"""Port vs reference: the serving slice (repro_torch.serve) as a whole.

A port `ServeRuntime(device="cpu")` serves int8, bf16 and fp32 tenants
(QAT formats as in examples/serve_equalizer.py) from params drawn by the
JAX package and carried across as numpy. Inside the port each streamed
output is bitwise equal to the port's offline engine (contract #4: chunked
== offline; #5: stacked == solo). Against the reference, on the same
waveforms: the JAX `ServeRuntime` and offline engine, exactly for int8,
within rtol=1e-6/atol=5e-6 for fp32 and atol=1e-5 for bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import equalizer_ht as HT
from repro.core import equalizer as jeq
from repro.kernels.cnn_eq import ref as jref
from repro.serve import BatchPolicy as JPolicy
from repro.serve import ServeRuntime as JRuntime
from repro.serve import StreamChunker as JChunker
from repro.serve import TenantSpec as JSpec
from repro_torch.core import equalizer as teq
from repro_torch.serve import (BatchPolicy, CorruptOutput, Fault, FaultPlan,
                               InjectedFault, ServeRuntime, StreamChunker,
                               TenantSpec)

RTOL, ATOL = 1e-6, 5e-6
BF16_ATOL = 1e-5
CFG = teq.CNNEqConfig()
FORMATS = {
    "ht": {"w_int": 2, "w_frac": 5, "a_int": 3, "a_frac": 4},   # → int8
    "lp": {"w_int": 3, "w_frac": 8, "a_int": 3, "a_frac": 8},   # → bf16
    "fp": None,                                                 # → fp32
}
BACKEND = {"ht": "fused_int8", "lp": "fused_bf16", "fp": "fused_fp32"}


def _params(op, idx):
    params = jax.tree.map(np.asarray,
                          jeq.init(jax.random.PRNGKey(100 * idx + len(op)),
                                   HT.CNN))
    rng = np.random.default_rng(idx)
    state = {"bn": [{"mean": (0.1 * rng.standard_normal(5)).astype(
                        np.float32),
                     "var": (1 + 0.5 * rng.random(5)).astype(np.float32)}
                    for _ in range(HT.CNN.layers - 1)]}
    if FORMATS[op] is not None:
        params["qat"] = {f"layer{i}": {k: np.float32(v)
                                       for k, v in FORMATS[op].items()}
                         for i in range(HT.CNN.layers)}
    return params, state


def _tenants(ops=("ht", "ht", "lp", "lp", "fp"), tile_m=16):
    out = []
    for i, op in enumerate(ops):
        params, state = _params(op, i)
        out.append(TenantSpec(f"{op}-{i}", CFG, params=params,
                              bn_state=state, tile_m=tile_m))
    return out


def _waves(specs, n_syms, seed=0):
    rng = np.random.default_rng(seed)
    return {s.tenant_id: rng.standard_normal(n_syms * 2).astype(np.float32)
            for s in specs}


def _chop(w, mean, rng):
    out, i = [], 0
    while i < w.shape[0]:
        n = max(1, int(mean * rng.uniform(0.2, 1.8)))
        out.append(w[i:i + n])
        i += n
    return out


def _serve(rt, waves, mean, seed=1):
    rng = np.random.default_rng(seed)
    streams = {tid: _chop(w, mean, rng) for tid, w in waves.items()}
    for r in range(max(len(c) for c in streams.values())):
        for tid, chunks in streams.items():
            if r < len(chunks):
                rt.submit(tid, chunks[r])
    return {tid: rt.close(tid) for tid in streams}


def _jax_offline(spec, wave):
    """The reference engine's weights, through the reference oracles."""
    params = jax.tree.map(jnp.asarray, spec.params)
    state = jax.tree.map(jnp.asarray, spec.bn_state)
    from repro.core.engine import EqualizerEngine as JEngine
    je = JEngine.from_params(params, state, HT.CNN, tile_m=16,
                             interpret=True)
    st = jeq.layer_strides(HT.CNN)
    x = jnp.asarray(wave[None])
    if je.backend == "fused_int8":
        y = jref.cnn_eq_quant(x, je.weights, st, je.formats)
    elif je.backend == "fused_bf16":
        y = jref.cnn_eq_bf16(x, je._bweights, st)
    else:
        y = jref.cnn_eq(x, je.weights, st)
    return je.backend, np.asarray(y)[0]


@pytest.mark.parametrize("mean_chunk", [37, 700])
def test_served_streams_equal_offline_and_reference(mean_chunk):
    specs = _tenants()
    waves = _waves(specs, 600)
    rt = ServeRuntime(BatchPolicy(max_batch=2, max_wait_s=1e9),
                      device="cpu")
    for s in specs:
        assert rt.open(s).engine.backend == BACKEND[s.tenant_id[:2]]
    outs = _serve(rt, waves, mean_chunk)
    st = rt.stats()
    assert st["launches"] > 0 and st["mean_batch"] > 1
    for s in specs:
        tid = s.tenant_id
        offline = s.build_engine("cpu")(waves[tid]).numpy()
        assert outs[tid].shape == offline.shape == (600,)
        np.testing.assert_array_equal(outs[tid], offline)
        backend, want = _jax_offline(s, waves[tid])
        assert backend == BACKEND[tid[:2]]
        if backend == "fused_int8":
            np.testing.assert_array_equal(outs[tid], want)
        elif backend == "fused_bf16":
            np.testing.assert_allclose(outs[tid], want, rtol=0,
                                       atol=BF16_ATOL)
        else:
            np.testing.assert_allclose(outs[tid], want, rtol=RTOL, atol=ATOL)


def test_int8_streams_equal_jax_serve_runtime_exactly():
    specs = _tenants(ops=("ht", "ht"), tile_m=64)
    waves = _waves(specs, 500, seed=3)
    rt = ServeRuntime(BatchPolicy(max_batch=2, max_wait_s=1e9),
                      device="cpu")
    for s in specs:
        rt.open(s)
    got = _serve(rt, waves, 900, seed=4)
    jrt = JRuntime(JPolicy(max_batch=2, max_wait_s=1e9))
    for s in specs:
        jrt.open(JSpec(s.tenant_id, HT.CNN,
                       params=jax.tree.map(jnp.asarray, s.params),
                       bn_state=jax.tree.map(jnp.asarray, s.bn_state),
                       tile_m=64))
    want = _serve(jrt, waves, 900, seed=4)
    for tid in waves:
        np.testing.assert_array_equal(got[tid], want[tid])


def test_chunker_plans_match_reference():
    rng = np.random.default_rng(5)
    for halo, ts, tile_m in [(68, 16, 16), (5, 4, 3), (0, 2, 1)]:
        a, b = StreamChunker(halo, ts, tile_m), JChunker(halo, ts, tile_m)
        for step in range(30):
            x = rng.standard_normal(int(rng.integers(0, 90))).astype(
                np.float32)
            a.push(x)
            b.push(x)
            if step == 29:
                a.finish()
                b.finish()
            pa, pb = a.plan(), b.plan()
            assert (pa is None) == (pb is None)
            if pa is not None:
                assert (pa.skip, pa.n_emit) == (pb.skip, pb.n_emit)
                np.testing.assert_array_equal(pa.data, pb.data)
                a.commit(pa)
                b.commit(pb)
            assert a.carry_samples == b.carry_samples


def test_max_batch_coalesces_and_groups_split_by_backend():
    specs = _tenants(ops=("ht", "ht", "ht", "lp", "lp"), tile_m=16)
    rt = ServeRuntime(BatchPolicy(max_batch=3, max_wait_s=1e9),
                      device="cpu")
    for s in specs:
        rt.open(s)
    waves = _waves(specs, 256, seed=6)
    for tid, w in waves.items():
        rt.submit(tid, w)
    # the three int8 tenants filled a batch and launched at once; the two
    # bf16 tenants wait for a third (max_wait is effectively off)
    assert rt.batcher.launches == 1 and rt.batcher.batch_sizes[-1] == 3
    assert rt.stats()["pending"] == 2
    assert rt.drain() == 1
    traffic = rt.stats()["traffic"]
    assert set(traffic) == {"L3_K9_fused_int8", "L3_K9_fused_bf16"}


def test_streams_survive_engine_eviction():
    specs = _tenants(ops=("ht", "lp", "fp"), tile_m=16)
    waves = _waves(specs, 400, seed=7)
    rt = ServeRuntime(BatchPolicy(max_batch=1), max_engines=1, device="cpu")
    for s in specs:
        rt.open(s)
    outs = _serve(rt, waves, 150, seed=8)
    assert rt.pool.stats()["evictions"] > 0
    for s in specs:
        np.testing.assert_array_equal(
            outs[s.tenant_id], s.build_engine("cpu")(waves[s.tenant_id]))


def test_weight_swap_keeps_each_epoch_bitwise():
    spec = _tenants(ops=("ht",), tile_m=16)[0]
    new_params, new_state = _params("ht", 9)
    rt = ServeRuntime(device="cpu")
    rt.open(spec)
    wave = _waves([spec], 512, seed=9)[spec.tenant_id]
    rt.submit(spec.tenant_id, wave[:400])
    rt.drain()
    epoch = rt.swap_weights(spec.tenant_id, params=new_params,
                            bn_state=new_state)
    assert epoch == 1
    first_new = rt.sessions.get(spec.tenant_id).swap_log[-1][1]
    rt.submit(spec.tenant_id, wave[400:])
    out = rt.close(spec.tenant_id)
    old = spec.build_engine("cpu")(wave).numpy()
    new = TenantSpec("n", CFG, params=new_params, bn_state=new_state,
                     formats=((2, 5, 3, 4),) * 3, backend="fused_int8",
                     tile_m=16).build_engine("cpu")(wave).numpy()
    cut = first_new * CFG.v_parallel
    np.testing.assert_array_equal(out[:cut], old[:cut])
    np.testing.assert_array_equal(out[cut:], new[cut:])


def test_injected_launch_fault_requeues_and_sentinel_rejects():
    specs = _tenants(ops=("fp",), tile_m=16)
    waves = _waves(specs, 300, seed=10)
    tid = specs[0].tenant_id
    rt = ServeRuntime(BatchPolicy(max_batch=1), device="cpu",
                      fault_plan=FaultPlan([Fault("launch_error", at=0)]))
    rt.open(specs[0])
    with pytest.raises(InjectedFault):
        rt.submit(tid, waves[tid])
    assert rt.stats()["pending"] == 1          # requeued, not lost
    np.testing.assert_array_equal(rt.close(tid),
                                  specs[0].build_engine("cpu")(waves[tid]))
    rt2 = ServeRuntime(BatchPolicy(max_batch=1), device="cpu",
                       sentinel_limit=1e3,
                       fault_plan=FaultPlan([Fault("corrupt", at=0)]))
    rt2.open(specs[0])
    with pytest.raises(CorruptOutput):
        rt2.submit(tid, waves[tid])
    snap = rt2.obs.snapshot()
    assert "serve" in snap and snap["serve"]["tenants"] == 1


def test_serve_aware_retune_uses_live_traffic(tmp_path, monkeypatch):
    from repro_torch.core import autotune
    monkeypatch.setattr(autotune, "CACHE_PATH", tmp_path / "cache.json")
    monkeypatch.setattr(autotune, "DEFAULT_TILES", (16, 32))
    autotune.clear_cache()
    # fp32 tenants at K = 7: their kernel tiles by tile_m (every datapath
    # at the paper's widths takes none, test_serve_never_retunes_untiled_
    # kernels)
    cfg = teq.CNNEqConfig(kernel=7)
    specs = [TenantSpec(f"fp-{i}", cfg, params=teq.init(
                 torch.Generator().manual_seed(i), cfg, device="cpu"),
                 bn_state=teq.init_bn_state(cfg, device="cpu"), tile_m=16)
             for i in range(2)]
    rt = ServeRuntime(BatchPolicy(max_batch=2, retune_after=2), device="cpu")
    for s in specs:
        rt.open(s)
    _serve(rt, _waves(specs, 300, seed=11), 200, seed=12)
    late = TenantSpec("late", cfg, params=specs[0].params,
                      bn_state=specs[0].bn_state)          # tile_m="auto"
    session = rt.open(late)
    assert session.spec.tile_m in (16, 32)
    assert any(k.endswith("__B2_S" + k.split("_S")[-1])
               for k in autotune._load_disk())
    autotune.clear_cache()


@pytest.mark.parametrize("op", ["ht", "lp", "fp"])
def test_serve_never_retunes_untiled_kernels(tmp_path, monkeypatch, op):
    from repro_torch.core import autotune
    from repro_torch.core.engine import UNTIMED_TILE_M
    monkeypatch.setattr(autotune, "CACHE_PATH", tmp_path / "cache.json")
    autotune.clear_cache()
    specs = _tenants(ops=(op, op), tile_m=16)
    rt = ServeRuntime(BatchPolicy(max_batch=2, retune_after=2), device="cpu")
    for s in specs:
        rt.open(s)
    _serve(rt, _waves(specs, 300, seed=11), 200, seed=12)
    late = TenantSpec("late", CFG, params=specs[0].params,
                      bn_state=specs[0].bn_state)          # tile_m="auto"
    session = rt.open(late)
    assert session.engine.backend == BACKEND[op]
    assert session.spec.tile_m == "auto"
    assert session.engine.resolved_tile_m() == UNTIMED_TILE_M
    assert autotune._load_disk() == {}
    autotune.clear_cache()
