"""Continuous-batching serving in the port: ``ServingEngine`` over the
port's ``OffloadedDecoder`` against the reference package's, on the same
numpy weights and requests, and the port's own serving contracts.

* fp32: every request's greedy tokens equal the reference engine's, and
  equal the request decoded alone (uncached, and through a fresh engine).
* bf16, within the port: continuously batched tokens equal each request
  served alone; the spec-decoding engine equals the plain engine.
* Counterparts of ``tests/test_serving.py``: EOS retires early, an
  oversized prompt is refused terminally, static equals continuous, the
  fake clock stamps exact metrics, an abort mid-run reclaims every page,
  closing is idempotent, requests and the scheduler validate their input;
  and the decode attention step is bitwise invariant to the cache extent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core import OffloadPolicy as JPolicy
from repro.core.kv_cache import DecodeSpec as JSpec
from repro.core.model_adapter import make_offloadable_lm as jax_lm
from repro.serve import OffloadedDecoder as JDecoder
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JEngine
from repro_torch.configs.base import ModelConfig
from repro_torch.core import DecodeSpec, OffloadPolicy
from repro_torch.core.model_adapter import from_numpy_units
from repro_torch.models.attention import gqa_step
from repro_torch.serve import (FifoScheduler, OffloadedDecoder, Request,
                               RequestState, ServingEngine, SpecConfig)

torch.set_num_threads(2)

KW = dict(name="tiny", family="dense", n_layers=3, d_model=64, n_heads=4,
          n_kv_heads=2, d_ff=128, vocab=256, qk_norm=True)
JCFG, TCFG = JConfig(**KW), ModelConfig(**KW)
SPEC = dict(batch=2, max_seq=32, bucket=8)
RAGGED = [(3, 6, 0.0), (6, 4, 0.0), (9, 5, 0.02), (5, 6, 0.05)]


@pytest.fixture(scope="module")
def units():
    return jax_lm(JCFG, jax.random.PRNGKey(0)).units


class FakeClock:
    """Advances only via sleep() plus a fixed tick per observation."""

    def __init__(self, tick=0.0):
        self.t = 0.0
        self.tick = tick

    def __call__(self):
        now = self.t
        self.t += self.tick
        return now

    def sleep(self, d):
        self.t += d


def _engine(decoder, tick=0.0, cls=ServingEngine, **kw):
    clk = FakeClock(tick)
    return cls(decoder, clock=clk, sleep=clk.sleep, **kw)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(3, 256, size=n,
                                                dtype=np.int32)


def _requests(specs, cls=Request):
    """specs: (prompt_len, max_new, arrival[, eos]) tuples."""
    return [cls(rid=f"r{i}", prompt=_prompt(s[0], i), max_new_tokens=s[1],
                arrival=s[2], eos_token=s[3] if len(s) > 3 else None)
            for i, s in enumerate(specs)]


def _decoder(units, root, compute="float32", decode=True, **spec_kw):
    model = from_numpy_units(TCFG, units, getattr(torch, compute),
                             device="cpu")
    policy = (OffloadPolicy.preset("memascend").with_store(root)
              .with_adam(compute_dtype=compute).build())
    spec = DecodeSpec(**{**SPEC, **spec_kw}) if decode else None
    return OffloadedDecoder(model, policy, decode=spec)


def _solo(dec, req):
    """The request served alone through a fresh engine run."""
    report = _engine(dec).run([Request(rid=req.rid, prompt=req.prompt,
                                       max_new_tokens=req.max_new_tokens,
                                       eos_token=req.eos_token)])
    return report.requests[0].output


def test_continuous_matches_reference_and_solo(units, tmp_store_root):
    """fp32: ragged arrivals, joins, retires and slot reuse give each
    request the reference engine's tokens and its solo greedy tokens; a
    second run repeats the first."""
    jpol = (JPolicy.preset("memascend").with_store(tmp_store_root + "/j")
            .with_adam(compute_dtype="float32").build())
    with JDecoder(jax_lm(JCFG, jax.random.PRNGKey(0), jnp.float32), jpol,
                  decode=JSpec(**SPEC)) as jdec:
        ref = _engine(jdec, 0.005, JEngine).run(_requests(RAGGED, JRequest))
    with _decoder(units, tmp_store_root + "/t") as dec:
        report = _engine(dec, 0.005).run(_requests(RAGGED))
        again = _engine(dec, 0.005).run(_requests(RAGGED))
        solo = {r.rid: _solo(dec, r) for r in report.requests}
    with _decoder(units, tmp_store_root + "/u", decode=False) as dec:
        uncached = {r.rid: list(dec.generate(
            np.tile(r.prompt, (2, 1)), r.max_new_tokens)[0])
            for r in report.requests}
    assert [r.state for r in report.requests] == [RequestState.DONE] * 4
    assert report.kv_stats["reclaims"] > 0
    assert report.occupancy > 0.5
    for r, j, r2 in zip(report.requests, ref.requests, again.requests,
                        strict=True):
        assert r.rid == j.rid
        assert r.output == j.output, f"{r.rid} differs from the reference"
        assert r.output == solo[r.rid] == uncached[r.rid]
        assert r.output == r2.output
        assert r.metrics.tokens_out == len(r.output)


def test_bf16_continuous_equals_solo_and_spec_engine(units, tmp_store_root):
    """bf16 within the port: each request's continuously batched tokens
    equal it served alone, and the spec-decoding engine (per-slot
    rollback) emits the plain engine's tokens."""
    with _decoder(units, tmp_store_root, "bfloat16", max_seq=96,
                  bucket=16) as dec:
        pat = _prompt(5, 9)
        reqs = [Request(rid=f"r{i}", prompt=np.tile(pat, 2 + i),
                        max_new_tokens=8 + 3 * i, arrival=0.05 * i)
                for i in range(4)]
        plain = _engine(dec).run(reqs)
        for r in plain.requests:
            assert r.output == _solo(dec, r)
        fast = _engine(dec, spec=SpecConfig(k=4)).run(
            [Request(rid=r.rid, prompt=r.prompt,
                     max_new_tokens=r.max_new_tokens, arrival=r.arrival)
             for r in reqs])
        assert dec.spec_stats is not None
    for rp, rs in zip(plain.requests, fast.requests, strict=True):
        assert rp.output == rs.output
    total = sum(r.metrics.tokens_out for r in fast.completed)
    assert fast.spec_committed == total - len(fast.completed)
    assert fast.spec_rounds > 0 and fast.accepted_per_step > 0.0
    assert fast.kv_stats["rollbacks"] > 0


def test_eos_retires_slot_early(units, tmp_store_root):
    with _decoder(units, tmp_store_root) as dec:
        full = _engine(dec).run(_requests([(4, 8, 0.0)])).requests[0].output
        idx = next(i for i, t in enumerate(full) if t not in full[:i])
        report = _engine(dec).run(_requests(
            [(4, 8, 0.0, full[idx]), (5, 3, 0.0), (6, 3, 0.0)]))
    assert report.requests[0].output == full[:idx + 1]
    assert all(r.state is RequestState.DONE for r in report.requests)


def test_scheduler_refuses_oversized_prompt_terminally(units,
                                                       tmp_store_root):
    with _decoder(units, tmp_store_root, max_seq=16, bucket=4,
                  page_tokens=4, resident_pages=2) as dec:
        probe = dec.session.open_kv_cache()
        assert probe.admissible(12) and not probe.admissible(13)
        probe.close()
        report = _engine(dec).run(_requests([(14, 4, 0.0), (4, 3, 0.0)]))
    assert report.requests[0].state is RequestState.REFUSED
    assert report.requests[0].output == []
    assert report.requests[1].state is RequestState.DONE
    assert len(report.requests[1].output) == 3


def test_static_mode_matches_continuous_tokens(units, tmp_store_root):
    specs = [(3, 5, 0.0), (6, 3, 0.0), (4, 4, 0.01)]
    with _decoder(units, tmp_store_root) as dec:
        cont = _engine(dec, 0.005).run(_requests(specs))
        stat = _engine(dec, 0.005).run(_requests(specs), mode="static")
    assert all(r.state is RequestState.DONE for r in stat.requests)
    for rc, rs in zip(cont.requests, stat.requests, strict=True):
        assert rc.output == rs.output


def test_gqa_step_bitwise_invariant_to_cache_extent(units):
    """A row's bf16 decode attention is bitwise the same however far the
    shared extent stretches past its length (junk past it is masked)."""
    chunk, length = 8, 5
    params = {k: torch.from_numpy(v.copy()).to(torch.bfloat16)
              for k, v in units[1].params.items() if k.startswith("attn.")}
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 1, TCFG.d_model))).to(
        torch.bfloat16)
    kh, hd = TCFG.n_kv_heads, TCFG.head_dim
    valid_k = rng.normal(size=(2, length, kh, hd))
    valid_v = rng.normal(size=(2, length, kh, hd))
    outs = []
    for extent in (chunk, 3 * chunk):
        k = rng.normal(size=(2, extent, kh, hd)) * 50.0
        v = rng.normal(size=(2, extent, kh, hd)) * 50.0
        k[:, :length], v[:, :length] = valid_k, valid_v
        out, _k, _v = gqa_step(
            params, x, TCFG, torch.from_numpy(k).to(torch.bfloat16),
            torch.from_numpy(v).to(torch.bfloat16),
            torch.tensor([length, extent - 1]), chunk=chunk)
        outs.append(out[0])
    assert torch.equal(outs[0], outs[1])


def test_fake_clock_arrival_and_queue_metrics(units, tmp_store_root):
    with _decoder(units, tmp_store_root) as dec:
        report = _engine(dec).run(_requests([(4, 2, 0.0), (4, 2, 5.0)]))
    r0, r1 = report.requests
    assert r0.metrics.ttft_s == 0.0 and r0.metrics.queue_wait_s == 0.0
    assert r1.metrics.admitted_at == 5.0
    assert r1.metrics.queue_wait_s == 0.0
    assert report.duration_s == 5.0
    assert report.ttft_percentile(99) == 0.0


def test_run_reclaims_pages_on_mid_run_abort(units, tmp_store_root):
    """A compute failure mid-decode returns every weight and KV page to
    the pool, snapshots the KV stats, and the next run serves."""
    dec = _decoder(units, tmp_store_root)
    try:
        model, s = dec.session.model, dec.session
        real_step, calls = model.block_step, {"n": 0}

        def flaky_step(*a, **kw):
            calls["n"] += 1
            if calls["n"] == 7:
                raise RuntimeError("injected step failure")
            return real_step(*a, **kw)

        model.block_step = flaky_step
        with pytest.raises(RuntimeError, match="injected"):
            _engine(dec).run(_requests([(4, 6, 0.0), (5, 6, 0.0)]))
        assert s.pool.in_use_payload == 0
        assert dec.kv_stats is not None
        model.block_step = real_step
        report = _engine(dec).run(_requests([(4, 2, 0.0)]))
        assert report.requests[0].state is RequestState.DONE
    finally:
        dec.close()


def test_decoder_close_idempotent_stats_survive(units, tmp_store_root):
    dec = _decoder(units, tmp_store_root, max_seq=16)
    prompts = np.tile(_prompt(4, 0)[None, :], (2, 1))
    dec.generate(prompts, 2)
    live = dec.fetch_stats
    dec.close()
    dec.close()
    assert dec.closed and dec.fetch_stats == live
    assert set(dec.kv_overlap_stats) == {"kv_stage_gets", "kv_stage_hits",
                                         "kv_stage_wait_s"}
    with pytest.raises(RuntimeError, match="closed"):
        dec.generate(prompts, 1)
    with pytest.raises(RuntimeError, match="closed"):
        dec.step_logits(prompts)


def test_request_and_scheduler_validation(units, tmp_store_root):
    with pytest.raises(ValueError, match="non-empty"):
        Request(rid="a", prompt=np.zeros((0,), np.int32), max_new_tokens=1)
    with pytest.raises(ValueError, match="non-empty"):
        Request(rid="a", prompt=np.zeros((2, 2), np.int32), max_new_tokens=1)
    with pytest.raises(TypeError, match="integer"):
        Request(rid="a", prompt=np.ones(3, np.float32), max_new_tokens=1)
    with pytest.raises(ValueError, match="max_new_tokens"):
        Request(rid="a", prompt=np.ones(3, np.int32), max_new_tokens=0)
    dup = _requests([(3, 1, 0.0)]) + [Request(rid="r0",
                                              prompt=np.ones(3, np.int32),
                                              max_new_tokens=1)]
    with pytest.raises(ValueError, match="duplicate"):
        FifoScheduler(dup)
    with _decoder(units, tmp_store_root) as dec:
        with pytest.raises(ValueError, match="no requests"):
            _engine(dec).run([])
        with pytest.raises(ValueError, match="mode"):
            _engine(dec).run(_requests([(3, 1, 0.0)]), mode="eager")
        s = dec.session
        kv = s.open_kv_cache()
        for slot in sorted(kv.active):
            kv.retire(slot)
        slot = kv.join()
        with pytest.raises(ValueError, match="lengths"):
            s.prefill(kv, np.ones((2, 3), np.int32), slots=[slot])
        with pytest.raises(RuntimeError, match="no active slots|before"):
            s.decode_step_slots(kv, np.ones((2, 1), np.int32))
        kv.close()
    with _decoder(units, tmp_store_root + "/nd", decode=False) as dec:
        with pytest.raises(ValueError, match="DecodeSpec"):
            ServingEngine(dec)
