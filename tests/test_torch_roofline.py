"""The port's roofline analysis (``repro_torch.launch.roofline``) against
the reference's (``repro.launch.roofline``).

The arithmetic must be equal: analytic FLOPs and bytes for every
registered arch x every input shape, the trip-count-corrected collective
bytes of an HLO text, and a dry-run record's three terms when both are
given the same hardware constants.  The port's constants are the H100's
and its default.  The reference module imports no JAX, so this file
imports it directly.
"""
import dataclasses

import pytest

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import config_for_shape as jax_config_for_shape
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.launch import roofline as jref
from repro_torch.configs import SHAPES, config_for_shape, get_config
from repro_torch.launch import roofline

CASES = [(a, s) for a in jax_list_archs() for s in sorted(JAX_SHAPES)]

HLO = """HloModule train_step

%add (a: f32[], b: f32[]) -> f32[] {
  ROOT %r = f32[] add(f32[] %a, f32[] %b)
}

%cond.1 (p: (s32[], f32[8,128])) -> pred[] {
  %c = s32[] constant(12)
  ROOT %lt = pred[] compare(s32[] %i, s32[] %c), direction=LT
}

%inner_cond (p: (s32[], f32[4])) -> pred[] {
  %c2 = s32[] constant(3)
  ROOT %lt2 = pred[] compare(s32[] %j, s32[] %c2), direction=LT
}

%inner_body (p: (s32[], f32[4])) -> (s32[], f32[4]) {
  %ag = bf16[16,64]{1,0} all-gather(bf16[4,64]{1,0} %x), dimensions={0}
  ROOT %t2 = (s32[], f32[4]) tuple(%j, %y)
}

%body.1 (p: (s32[], f32[8,128])) -> (s32[], f32[8,128]) {
  %ar = f32[8,128]{1,0} all-reduce(f32[8,128]{1,0} %x), to_apply=%add
  %w2 = (s32[], f32[4]) while((s32[], f32[4]) %t), condition=%inner_cond, body=%inner_body
  %rs = (f32[2,128], f32[2,128]) reduce-scatter(f32[8,128] %a, f32[8,128] %b), dimensions={0}
  ROOT %t = (s32[], f32[8,128]) tuple(%i, %ar)
}

ENTRY %main (x: f32[8,128]) -> f32[8,128] {
  %w = (s32[], f32[8,128]) while((s32[], f32[8,128]) %init), condition=%cond.1, body=%body.1
  %cp = u8[1000]{0} collective-permute-start(u8[1000]{0} %z), source_target_pairs={{0,1}}
  %a2a = s32[10,10] all-to-all(s32[10,10] %q), dimensions={0}
  ROOT %o = f32[8,128] get-tuple-element(%w), index=1
}
"""


def test_constants_are_the_h100s():
    hw = roofline.H100
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw, hw.hbm_bytes) == (
        989e12, 3.35e12, 900e9, 80e9)
    assert roofline.HW() == hw
    assert not hasattr(roofline, "V5E")
    assert sorted(SHAPES) == sorted(JAX_SHAPES)


@pytest.mark.parametrize("arch,shape", CASES)
def test_analytic_flops_and_bytes_equal(arch, shape):
    jshape, tshape = JAX_SHAPES[shape], SHAPES[shape]
    jcfg = jax_config_for_shape(jax_get_config(arch), jshape)
    tcfg = config_for_shape(get_config(arch), tshape)
    assert roofline.analytic_flops(tcfg, tshape) == \
        jref.analytic_flops(jcfg, jshape)
    assert roofline.analytic_bytes(tcfg, tshape) == \
        jref.analytic_bytes(jcfg, jshape)


def test_corrected_collectives_equal():
    got = roofline.corrected_collectives(HLO)
    assert got == jref.corrected_collectives(HLO)
    # all-reduce 4 KiB and reduce-scatter 2 KiB, 12 trips; all-gather 2 KiB
    # bf16, 3 x 12 trips; the entry's permute and all-to-all once
    assert got["bytes_by_op"] == {
        "all-reduce": 12 * 4096, "reduce-scatter": 12 * 2048,
        "all-gather": 36 * 2048, "collective-permute": 1000,
        "all-to-all": 400}


@pytest.mark.parametrize("arch,shape,chips,coll", [
    ("granite-8b", "train_4k", 256, {"total_bytes": 3.5e9}),
    ("qwen3-moe-30b-a3b", "prefill_32k", 256, None),
    ("zamba2-1.2b", "decode_32k", 512, {"total_bytes": 1e6}),
    ("whisper-tiny", "long_500k", 256, {"total_bytes": 0.0}),
])
def test_analyze_record_equal_under_the_same_constants(arch, shape, chips,
                                                       coll):
    rec = {"arch": arch, "shape": shape, "chips": chips, "ok": True,
           "cost": {"flops": 1.25e15}}
    if coll is not None:
        rec["collectives_corrected"] = coll
    same = dataclasses.asdict(roofline.H100)
    got = roofline.analyze_record(dict(rec), roofline.HW(**same))
    want = jref.analyze_record(dict(rec), jref.HW(**same))
    assert got == want
    assert roofline.analyze_record(dict(rec)) == got     # the default


def test_train_step_flops_of_the_chip_path():
    """The card's train path: granite-8b cut to 8 layers, batch 2 x 4096;
    6 * N * D model FLOPs."""
    cfg = dataclasses.replace(get_config("granite-8b"), n_layers=8)
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=2)
    fl = roofline.analytic_flops(cfg, shape)
    assert fl["model_flops"] == 6 * cfg.active_params() * 2 * 4096
    assert 2.14e9 < cfg.active_params() < 2.16e9
