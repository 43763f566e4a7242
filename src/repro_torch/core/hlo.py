"""Compiled-HLO analysis: collective extraction + roofline terms.

Parses ``compiled.as_text()`` (post-SPMD, so all tensor shapes are
*per-device* shards) into:
  * the list of collective ops with wire-byte costs (ring-algorithm
    estimates per replica-group size),
  * while-loop trip counts (recovered from the loop-condition comparison
    constant), so collectives and FLOPs inside ``lax.scan`` bodies are
    multiplied by their true execution count,
  * the three roofline terms of the assignment:
        compute    = FLOPs / peak_FLOPs
        memory     = HBM bytes / HBM bandwidth
        collective = wire bytes / ICI link bandwidth
    (cost_analysis is per-device after SPMD partitioning — verified
    empirically — so no further division by chip count is needed.)

The port's own copy of the JAX package's parser (pure ``re``, so HLO text
prices without jax).  A captured PyTorch step gives the same
:class:`CollectiveOp` records through ``core.graph``.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

from .params import TpuSpec, TPU_V5E

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(type_str: str, strict: bool = False) -> int:
    """Total bytes of an HLO type string (handles tuples).

    Unknown dtypes are skipped by default (an HLO dump can carry opaque
    or token-typed operands we price as zero bytes); ``strict=True``
    raises ``ValueError`` instead, for callers that need to notice a
    dtype missing from the table rather than silently undercount.
    """
    total = 0
    for m in _SHAPE_RE.finditer(type_str):
        dtype, dims = m.group(1), m.group(2)
        if dtype not in _DTYPE_BYTES:
            if strict:
                raise ValueError(
                    f"unknown HLO dtype {dtype!r} in {type_str!r} "
                    f"(known: {', '.join(sorted(_DTYPE_BYTES))})")
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


@dataclass
class CollectiveOp:
    kind: str
    result_bytes: int          # per-device shard bytes of the result
    group_size: int            # replica-group size
    computation: str
    multiplier: float = 1.0    # product of enclosing loop trip counts
    name: str = ""

    @property
    def wire_bytes(self) -> float:
        """Ring-algorithm per-device wire bytes for ONE execution."""
        g, r = max(self.group_size, 1), self.result_bytes
        if g <= 1:
            return 0.0 if self.kind != "collective-permute" else float(r)
        if self.kind == "all-gather":
            return r * (g - 1) / g
        if self.kind == "all-reduce":
            return 2.0 * r * (g - 1) / g
        if self.kind == "reduce-scatter":
            return r * (g - 1)
        if self.kind == "all-to-all":
            return r * (g - 1) / g
        return float(r)        # collective-permute

    @property
    def total_wire_bytes(self) -> float:
        return self.wire_bytes * self.multiplier


# ---------------------------------------------------------------- parsing
_COMP_HDR = re.compile(r"^(?:ENTRY )?%?([\w\.\-]+)\s*(?:\([^)]*\))?[^{]*\{")
_WHILE_RE = re.compile(
    r"while\(.*?\)\s*,\s*condition=%?([\w\.\-]+)\s*,\s*body=%?([\w\.\-]+)")
_CALLS_RE = re.compile(r"calls=%?([\w\.\-]+)")
_CONST_S32 = re.compile(r"s32\[\]\s+constant\((\d+)\)")
_GROUPS_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")
_GROUPS_DIM_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def split_computations(text: str) -> dict:
    """HLO text -> {computation name: list of body lines}."""
    comps, cur, body = {}, None, []
    for line in text.splitlines():
        stripped = line.strip()
        if cur is None:
            m = _COMP_HDR.match(line)
            if m and line.rstrip().endswith("{"):
                cur, body = m.group(1), []
        else:
            if stripped == "}":
                comps[cur] = body
                cur = None
            else:
                body.append(stripped)
    return comps


def _entry_name(text: str) -> str:
    m = re.search(r"^ENTRY %?([\w\.\-]+)", text, re.M)
    return m.group(1) if m else next(iter(split_computations(text)), "")


def _group_size(line: str, default: int = 1) -> int:
    m = _GROUPS_RE.search(line)
    if m:
        first = m.group(1)
        return len([x for x in first.split(",") if x.strip() != ""])
    m = _GROUPS_DIM_RE.search(line)
    if m:
        return int(m.group(2))
    return default


def loop_trip_count(cond_lines) -> int:
    """Max s32[] constant in the condition region ~ the trip count."""
    best = 1
    for line in cond_lines:
        for m in _CONST_S32.finditer(line):
            best = max(best, int(m.group(1)))
    return best


def computation_multipliers(text: str) -> dict:
    """{computation: product of enclosing while-loop trip counts}."""
    comps = split_computations(text)
    entry = _entry_name(text)
    mult = {entry: 1.0}
    stack = [entry]
    while stack:
        cur = stack.pop()
        m = mult[cur]
        for line in comps.get(cur, ()):
            w = _WHILE_RE.search(line)
            if w:
                cond, body = w.group(1), w.group(2)
                trips = loop_trip_count(comps.get(cond, ()))
                for child in (cond, body):
                    if mult.get(child, 0) < m * trips:
                        mult[child] = m * trips
                        stack.append(child)
                continue
            for c in _CALLS_RE.finditer(line):
                child = c.group(1)
                if mult.get(child, 0) < m:
                    mult[child] = m
                    stack.append(child)
    return mult


def parse_collectives(text: str, correct_cpu_f32: bool = True) -> list:
    """All collective ops with per-device wire-byte costs and loop
    multipliers.  ``-start`` variants are counted once (the ``-done`` is
    the same transfer).

    ``correct_cpu_f32``: XLA CPU's float-normalization rewrites bf16
    collectives into f32 (verified: every activation all-reduce in the
    compiled text is f32 with a same-shape bf16 twin present); on the TPU
    target they run in bf16, so f32 collectives whose dims also appear in
    bf16 are priced at 2 bytes/element."""
    comps = split_computations(text)
    mult = computation_multipliers(text)
    bf16_dims = set(re.findall(r"bf16\[([\d,]+)\]", text)) \
        if correct_cpu_f32 else set()
    ops = []
    op_re = re.compile(
        r"%?([\w\.\-]+)\s*=\s*(\([^)]*\)|[^\s]+)\s+("
        + "|".join(k + "(?:-start)?" for k in COLLECTIVE_KINDS) + r")\(")
    for comp, lines in comps.items():
        for line in lines:
            m = op_re.search(line)
            if not m:
                continue
            name, type_str, kind = m.group(1), m.group(2), m.group(3)
            base_kind = kind.replace("-start", "")
            nbytes = 0
            for sm in _SHAPE_RE.finditer(type_str):
                dtype, dims = sm.group(1), sm.group(2)
                if dtype not in _DTYPE_BYTES:
                    continue
                n = 1
                if dims:
                    for d in dims.split(","):
                        n *= int(d)
                per_elem = _DTYPE_BYTES[dtype]
                if dtype == "f32" and dims in bf16_dims:
                    per_elem = 2            # TPU-target bf16 collective
                nbytes += n * per_elem
            ops.append(CollectiveOp(
                kind=base_kind,
                result_bytes=nbytes,
                group_size=_group_size(line),
                computation=comp,
                multiplier=mult.get(comp, 1.0),
                name=name))
    return ops


def collective_wire_bytes(text: str) -> float:
    return sum(op.total_wire_bytes for op in parse_collectives(text))


# ------------------------------------------------- input/output aliasing
_ALIAS_ENTRY_RE = re.compile(
    r"\{([\d,\s]*)\}\s*:\s*\((\d+)\s*,\s*\{([\d,\s]*)\}")


def input_output_aliases(text: str) -> list:
    """``[(output_index, param_number, param_index), ...]`` parsed from the
    ``input_output_alias=`` field of the HloModule header.

    This is how XLA records buffer donation: a ``donate_argnums`` that
    actually took effect shows up as one alias entry per donated parameter
    leaf (output tuple index -> (parameter number, index within the
    parameter)).  A declared donation that could NOT be used (shape/dtype
    mismatch, buffer still needed) simply has no entry — the absence the
    IR-tier donation pass turns into a finding.  Returns ``[]`` when the
    module has no alias field at all.
    """
    start = text.find("input_output_alias={")
    if start < 0:
        return []
    i = text.find("{", start)
    depth, j = 0, i
    while j < len(text):                       # balanced-brace scan: entries
        if text[j] == "{":                     # themselves contain braces
            depth += 1
        elif text[j] == "}":
            depth -= 1
            if depth == 0:
                break
        j += 1
    block = text[i:j + 1]

    def ints(s: str) -> tuple:
        return tuple(int(x) for x in s.split(",") if x.strip() != "")

    return [(ints(m.group(1)), int(m.group(2)), ints(m.group(3)))
            for m in _ALIAS_ENTRY_RE.finditer(block)]


#: Opcodes that move bytes purely to change layout / materialize a copy.
LAYOUT_CHURN_OPS = frozenset(("copy", "transpose"))


def layout_churn_bytes(text: str) -> float:
    """Loop-corrected result bytes of ``copy`` / ``transpose`` ops — data
    movement that exists only to rearrange layout.  A growing number here
    usually means a new op sequence forces XLA to materialize physical
    relayouts on a hot path (the IR-tier ``layout-churn`` metric baselines
    it per entry point)."""
    comps = split_computations(text)
    mult = computation_multipliers(text)
    total = 0.0
    for comp, lines in comps.items():
        m_comp = mult.get(comp, 1.0)
        for line in lines:
            m = _OP_RE.match(line)
            if m and m.group(3) in LAYOUT_CHURN_OPS:
                total += _shape_bytes(m.group(2)) * m_comp
    return total


def cpu_bf16_normalization_bytes(text: str,
                                 min_bytes: int = 64 * 2 ** 20) -> float:
    """Bytes of f32 twin buffers XLA CPU materializes for bf16 loop
    carries (float-normalization: CPU has no native bf16 compute, so the
    backend keeps f32 copies of bf16 while-carried stacks).  These buffers
    do NOT exist on TPU, where bf16 is MXU-native — verified by the
    presence of both ``bf16[dims]`` and ``f32[dims]`` twins of the same
    large stacked shape.  The dry-run subtracts this from ``live_bytes``
    to produce the TPU-target estimate (documented heuristic: one f32 twin
    per distinct large shape that also appears in bf16)."""
    bf16_dims = set()
    f32_dims = set()
    for m in _SHAPE_RE.finditer(text):
        dtype, dims = m.group(1), m.group(2)
        if not dims:
            continue
        if dtype == "bf16":
            bf16_dims.add(dims)
        elif dtype == "f32":
            f32_dims.add(dims)
    total = 0.0
    for dims in f32_dims & bf16_dims:
        n = 1
        for d in dims.split(","):
            n *= int(d)
        if n * 4 >= min_bytes and dims.count(",") >= 2:
            # multiplicity: distinct loop-carried f32 buffers of this shape
            # == distinct dynamic-update-slice producers (e.g. the K and V
            # cache twins are two separate buffers of one shape)
            dus = set(re.findall(
                r"%([\w\.\-]+)\s*=\s*f32\[" + re.escape(dims)
                + r"\][^=]*?dynamic-update-slice", text))
            total += n * 4 * max(1, len(dus))
    return total


# --------------------------------------------------------------- roofline
@dataclass
class RooflineTerms:
    """All times in seconds, per-device quantities."""

    flops: float                   # per-device FLOPs (loop-corrected)
    hbm_bytes: float               # per-device HBM traffic (loop-corrected)
    wire_bytes: float              # per-device ICI wire bytes
    spec: TpuSpec = field(default_factory=lambda: TPU_V5E)
    ici_links_used: int = 1

    @property
    def compute_s(self) -> float:
        return self.flops / self.spec.peak_bf16_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / self.spec.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.wire_bytes / (self.spec.ici_link_bw * self.ici_links_used)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline estimate: terms overlap perfectly -> max()."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "wire_bytes": self.wire_bytes,
                "compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s,
                "dominant": self.dominant, "step_time_s": self.step_time_s}


# ------------------------------------------------- per-computation costing
_OP_RE = re.compile(
    r"^(?:ROOT\s+)?%?([\w\.\-]+)\s*=\s*(\([^=]*?\)|\S+)\s+([\w\-]+)")
_OPERANDS_RE = re.compile(r"%([\w\.\-]+)")
_CONTRACT_RE = re.compile(r"lhs_contracting_dims=\{([\d,]*)\}")

#: opcodes whose operand+result traffic plausibly hits HBM (fusions read
#: inputs / write outputs; the rest are data movers or unfused heavies).
_TRAFFIC_OPS = frozenset((
    "fusion", "dot", "convolution", "copy", "slice", "dynamic-slice",
    "dynamic-update-slice", "transpose", "broadcast", "reduce", "sort",
    "gather", "scatter", "concatenate", "pad", "select-and-scatter",
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute", "cholesky", "triangular-solve"))


def _symbol_table(lines) -> dict:
    """{op name: (type_str, opcode, full line)} for one computation."""
    out = {}
    for line in lines:
        m = _OP_RE.match(line)
        if m:
            out[m.group(1)] = (m.group(2), m.group(3), line)
    return out


def _dims(type_str: str) -> list:
    m = _SHAPE_RE.search(type_str)
    if not m or not m.group(2):
        return []
    return [int(d) for d in m.group(2).split(",")]


def _dot_flops(line: str, symtab: dict) -> float:
    """2 * prod(result dims) * prod(lhs contracting dim sizes)."""
    m = _OP_RE.match(line)
    result_elems = math.prod(_dims(m.group(2))) if _dims(m.group(2)) else 1
    paren = line[line.find(m.group(3)) + len(m.group(3)):]
    operands = _OPERANDS_RE.findall(paren[:paren.find(")")])
    contract = _CONTRACT_RE.search(line)
    k = 1
    if operands and contract and operands[0] in symtab:
        lhs_dims = _dims(symtab[operands[0]][0])
        for ci in contract.group(1).split(","):
            if ci != "" and int(ci) < len(lhs_dims):
                k *= lhs_dims[int(ci)]
    return 2.0 * result_elems * k


def computation_costs(text: str) -> dict:
    """{computation: {"dot_flops": f, "bytes": b}} — one execution each."""
    comps = split_computations(text)
    out = {}
    for comp, lines in comps.items():
        symtab = _symbol_table(lines)
        flops, traffic = 0.0, 0.0
        for line in lines:
            m = _OP_RE.match(line)
            if not m:
                continue
            opcode = m.group(3)
            if opcode in ("dot", "convolution"):
                flops += _dot_flops(line, symtab)
            if opcode in _TRAFFIC_OPS:
                traffic += _shape_bytes(m.group(2))
                paren = line[line.find(opcode) + len(opcode):]
                close = paren.find(")")
                for op_name in _OPERANDS_RE.findall(paren[:close]):
                    if op_name in symtab:
                        traffic += _shape_bytes(symtab[op_name][0])
        out[comp] = {"dot_flops": flops, "bytes": traffic}
    return out


def loop_corrected_cost(cost: dict, text: str) -> tuple:
    """(flops, hbm_bytes) with while-loop trip counts applied.

    ``cost_analysis`` counts every computation ONCE (verified empirically)
    and fusion-internal dots are invisible in its aggregate, so we price the
    module ourselves: exact dot FLOPs per computation (result dims x
    contracting dims from the HLO symbol table) and operand+result traffic
    of the HBM-visible ops, each scaled by the computation's loop
    multiplier.  The raw cost_analysis numbers are reported alongside for
    cross-checking.
    """
    mult = computation_multipliers(text)
    costs = computation_costs(text)
    flops = sum(c["dot_flops"] * mult.get(name, 1.0)
                for name, c in costs.items())
    hbm = sum(c["bytes"] * mult.get(name, 1.0) for name, c in costs.items())
    # fall back to cost_analysis when the module has no parseable dots
    if flops == 0.0:
        flops = float(cost.get("flops", 0.0) or 0.0)
    if hbm == 0.0:
        hbm = float(cost.get("bytes accessed", 0.0) or 0.0)
    return flops, hbm
