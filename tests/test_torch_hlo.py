"""The port's HLO parser (``repro_torch.core.hlo``, its own copy of the JAX
package's pure-``re`` module) against the JAX package's on the same text:
every case of ``tests/test_hlo.py`` and ``tests/test_hlo_advisor.py``.
The texts are the reference tests' synthetic strings and programs that JAX
compiles here on the CPU; both parsers read the same string, and every
result must be equal exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest

from repro.compat import normalize_cost_analysis
from repro.core import hlo as ref
from repro_torch.core import hlo as pt
from test_hlo import NESTED_WHILE_HLO
from test_hlo_advisor import SYNTH_HLO

NON_CHURN = ("ENTRY %main (p0: f32[8]) -> f32[8] {\n"
             "  %p0 = f32[8]{0} parameter(0)\n"
             "  ROOT %a = f32[8]{0} add(%p0, %p0)\n"
             "}\n")
ALIAS_HEADER = ("HloModule m, input_output_alias={ {0}: (0, {}, may-alias), "
                "{1}: (2, {0}, must-alias) }, entry_computation_layout=...\n")
BF16_TWIN = """
ENTRY %main () -> f32[] {
  %a = bf16[8,1,4096,8192]{3,2,1,0} parameter(0)
  %b = f32[8,1,4096,8192]{3,2,1,0} convert(%a)
  %small = f32[8]{0} constant(0)
}
"""


@pytest.fixture(scope="module")
def compiled():
    """JAX programs compiled on the CPU: the reference tests' scanned
    ``tanh(x @ w)`` and a donated / undonated ``a + 1``."""
    L, M, K = 6, 16, 32

    def f(x, ws):
        def body(c, w):
            return jnp.tanh(c @ w), None
        out, _ = jax.lax.scan(body, x, ws)
        return out

    scanned = jax.jit(f).lower(jax.ShapeDtypeStruct((M, K), jnp.float32),
                               jax.ShapeDtypeStruct((L, K, K), jnp.float32)
                               ).compile()
    x = jax.ShapeDtypeStruct((64,), jnp.float32)
    donated = jax.jit(lambda a: a + 1.0, donate_argnums=(0,)).lower(x) \
        .compile()
    plain = jax.jit(lambda a: a + 1.0).lower(x).compile()
    return {"scanned": (scanned.as_text(), normalize_cost_analysis(scanned)),
            "donated": (donated.as_text(), {}),
            "plain": (plain.as_text(), {})}


def _texts(compiled):
    return {"nested": NESTED_WHILE_HLO,
            "nested_zero": NESTED_WHILE_HLO.replace("constant(3)",
                                                    "constant(0)"),
            "synth": SYNTH_HLO, "non_churn": NON_CHURN,
            "alias": ALIAS_HEADER, "bf16_twin": BF16_TWIN,
            **{k: t for k, (t, _) in compiled.items()}}


TEXTS = ["nested", "nested_zero", "synth", "non_churn", "alias", "bf16_twin",
         "scanned", "donated", "plain"]


def _ops(mod, text):
    return [dataclasses.asdict(op) for op in mod.parse_collectives(text)]


@pytest.mark.parametrize("name", TEXTS)
def test_parsers_agree_on_text(compiled, name):
    """Computations, loop multipliers, collectives (with and without the
    CPU-f32 correction), wire bytes, aliases, layout churn, per-computation
    costs and the bf16 twins: equal on every text."""
    text = _texts(compiled)[name]
    assert pt.split_computations(text) == ref.split_computations(text)
    assert pt.computation_multipliers(text) \
        == ref.computation_multipliers(text)
    assert _ops(pt, text) == _ops(ref, text)
    for flag in (False, True):
        assert [dataclasses.asdict(o) for o in
                pt.parse_collectives(text, correct_cpu_f32=flag)] \
            == [dataclasses.asdict(o) for o in
                ref.parse_collectives(text, correct_cpu_f32=flag)]
    assert pt.collective_wire_bytes(text) == ref.collective_wire_bytes(text)
    assert pt.input_output_aliases(text) == ref.input_output_aliases(text)
    assert pt.layout_churn_bytes(text) == ref.layout_churn_bytes(text)
    assert pt.computation_costs(text) == ref.computation_costs(text)
    for min_bytes in (1024, 64 * 2 ** 20):
        assert pt.cpu_bf16_normalization_bytes(text, min_bytes) \
            == ref.cpu_bf16_normalization_bytes(text, min_bytes)


@pytest.mark.parametrize("name", ["scanned", "synth", "nested"])
def test_loop_corrected_cost_agrees(compiled, name):
    text = _texts(compiled)[name]
    cost = compiled[name][1] if name in compiled else {}
    assert pt.loop_corrected_cost(cost, text) \
        == ref.loop_corrected_cost(cost, text)
    if name == "scanned":
        flops, _ = pt.loop_corrected_cost(cost, text)
        assert flops == 2 * 16 * 32 * 32 * 6
        assert max(pt.computation_multipliers(text).values()) == 6


@pytest.mark.parametrize("lines", [
    ["%p = (s32[], f32[8]) parameter(0)",
     "%i = s32[] get-tuple-element(%p), index=0",
     "%j = s32[] get-tuple-element(%p), index=1",
     "ROOT %lt = pred[] compare(%i, %j), direction=LT"],
    ["%k = s32[] constant(0)"],
    ["%zero = s32[] constant(0)", "%k = s32[] constant(7)"]])
def test_loop_trip_count_agrees(lines):
    assert pt.loop_trip_count(lines) == ref.loop_trip_count(lines)


def test_nested_and_zero_trip_multipliers():
    mult = pt.computation_multipliers(NESTED_WHILE_HLO)
    assert (mult["main"], mult["outer_body"], mult["inner_body"]) \
        == (1.0, 3.0, 15.0)
    assert pt.layout_churn_bytes(NESTED_WHILE_HLO) == 36 * 15 + 32


def test_donated_jit_aliases(compiled):
    aliases = pt.input_output_aliases(compiled["donated"][0])
    assert aliases and aliases[0][1] == 0
    assert pt.input_output_aliases(compiled["plain"][0]) == []
    assert pt.input_output_aliases(ALIAS_HEADER) == [((0,), 0, ()),
                                                     ((1,), 2, (0,))]


@pytest.mark.parametrize("type_str", [
    "bf16[8,128]", "f32[]", "(f32[4,4], bf16[2])", "pred[16]",
    "(f32[2,3], s32[4])", "f8e4m3fn[128]", "f8e5m2[64]", "f32[0,128]",
    "opaque[8]", "(f32[2], opaque[8])", "c128[3]", "u64[2,2]"])
def test_shape_bytes_agree(type_str):
    assert pt._shape_bytes(type_str) == ref._shape_bytes(type_str)


def test_shape_bytes_strict_raises_alike():
    for mod in (pt, ref):
        with pytest.raises(ValueError, match="unknown HLO dtype"):
            mod._shape_bytes("opaque[8]", strict=True)


@pytest.mark.parametrize("kind", list(ref.COLLECTIVE_KINDS))
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_wire_bytes_formulas_agree(kind, group):
    a = pt.CollectiveOp(kind=kind, result_bytes=1000, group_size=group,
                        computation="main", multiplier=3.0)
    b = ref.CollectiveOp(kind=kind, result_bytes=1000, group_size=group,
                         computation="main", multiplier=3.0)
    assert (a.wire_bytes, a.total_wire_bytes) \
        == (b.wire_bytes, b.total_wire_bytes)


def test_roofline_terms_agree():
    a = pt.RooflineTerms(flops=197e12, hbm_bytes=819e9 * 3,
                         wire_bytes=50e9 * 0.5)
    b = ref.RooflineTerms(flops=197e12, hbm_bytes=819e9 * 3,
                          wire_bytes=50e9 * 0.5)
    assert a.as_dict() == b.as_dict()
    assert a.dominant == "memory" and a.step_time_s == pytest.approx(3.0)
    assert dataclasses.asdict(a.spec) == dataclasses.asdict(b.spec)


def test_synthetic_collectives():
    kinds = {o.kind: o for o in pt.parse_collectives(SYNTH_HLO)}
    assert set(kinds) == {"all-reduce", "all-gather"}
    assert kinds["all-reduce"].group_size == 4
    assert kinds["all-reduce"].result_bytes == 1024 * 1024 * 2
    assert kinds["all-gather"].group_size == 2
    assert pt.cpu_bf16_normalization_bytes(BF16_TWIN, min_bytes=1024) \
        == 8 * 1 * 4096 * 8192 * 4
