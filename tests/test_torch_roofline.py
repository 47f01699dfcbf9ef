"""The one-card roofline (``repro_torch.launch.roofline``) against the
reference's (``repro.launch.roofline``, which imports no device state):
the same model flops for every (arch, shape) pair, the same terms up to
the ratio of the two hardware models' constants, and the reference's
report columns."""

import itertools
import json

import pytest

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.launch import roofline as ref_roofline
from repro_torch.configs import ARCHS, INPUT_SHAPES
from repro_torch.launch import roofline

PAIRS = list(itertools.product(sorted(ARCHS), sorted(INPUT_SHAPES)))


def test_pairs_are_the_reference_s():
    assert set(PAIRS) == set(itertools.product(REF_ARCHS, REF_SHAPES))


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_model_flops_equal_the_reference(arch, shape):
    assert roofline.model_flops(arch, shape) == \
        ref_roofline.model_flops(arch, shape)


def _record(**over):
    rec = {"arch": "qwen3-4b", "shape": "train_4k", "status": "ok",
           "mesh": "1", "n_chips": 1,
           "cost": {"flops": 3.0e16, "bytes accessed": 8.0e14},
           "collectives": {"bytes": {"all-gather": 2.0e9,
                                     "all-reduce": 1.0e9}},
           "memory": {"argument_size_in_bytes": 8 << 30,
                      "temp_size_in_bytes": 40 << 30,
                      "output_size_in_bytes": 8 << 30}}
    rec.update(over)
    return rec


def test_terms_scale_by_the_ratio_of_the_constants():
    rec = _record()
    port, ref = roofline.analyze(rec), ref_roofline.analyze(rec)
    assert port.compute_s / ref.compute_s == pytest.approx(
        ref_roofline.PEAK_FLOPS / roofline.PEAK_FLOPS, rel=1e-12)
    assert port.memory_s / ref.memory_s == pytest.approx(
        ref_roofline.HBM_BW / roofline.HBM_BW, rel=1e-12)
    assert port.collective_s / ref.collective_s == pytest.approx(
        ref_roofline.LINK_BW / roofline.LINK_BW, rel=1e-12)
    assert roofline.link_bytes(rec["collectives"]) == \
        ref_roofline.link_bytes(rec["collectives"])
    assert port.model_flops == ref.model_flops
    assert port.useful_ratio == ref.useful_ratio
    assert port.temp_gib_per_chip == ref.temp_gib_per_chip


def test_h100_constants():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12


def test_floor_is_the_larger_term_and_one_card_moves_no_link_bytes():
    rec = _record(collectives={"bytes": {}, "counts": {}, "total_bytes": 0})
    r = roofline.analyze(rec)
    assert r.collective_s == 0.0
    assert r.floor_s == max(r.compute_s, r.memory_s)
    assert r.dominant == ("compute" if r.compute_s >= r.memory_s
                          else "memory")


def test_fits_is_the_predicted_peak_against_the_card():
    rec = _record()
    peak = 56 << 30
    assert roofline.analyze(rec, hbm_bytes=peak).fits
    r = roofline.analyze(rec, hbm_bytes=peak - 1)
    assert not r.fits and "SSD-offloaded" in r.note
    assert r.peak_gib == 56.0


def test_not_ok_records_have_no_roofline():
    assert roofline.analyze({"status": "skipped"}) is None


def test_report_prints_the_reference_columns(tmp_path):
    (tmp_path / "a.json").write_text(json.dumps(_record()))
    (tmp_path / "b.json").write_text(json.dumps(
        {"arch": "whisper-tiny", "shape": "long_500k", "status": "skipped",
         "reason": "enc-dec decoder cap"}))
    (tmp_path / "c.json").write_text(json.dumps(
        {"arch": "xlstm-1.3b", "shape": "prefill_32k", "status": "error",
         "error": "DryRunTimeout('budget')", "seconds": 600.1}))
    text = roofline.report(str(tmp_path))
    header = next(ln for ln in text.splitlines() if ln.startswith("| arch"))
    cols = [c.strip() for c in header.strip("|").split("|")]
    ref_cols = ["arch", "shape", "compute (s)", "memory (s)",
                "collective (s)", "dominant", "useful ratio",
                "temp GiB/chip", "what would move it"]
    assert [c for c in cols if c in ref_cols] == ref_cols
    assert "H100" in text and "not measured" in text
    assert "| qwen3-4b | train_4k |" in text
    assert "whisper-tiny/long_500k: skipped: enc-dec decoder cap" in text
    assert "xlstm-1.3b/prefill_32k: error" in text and "600.1 s" in text
