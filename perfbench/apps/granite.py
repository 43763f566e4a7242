"""The granite cells' app: granite-4.0-h's layers held by one pipeline
stage, served by the port's continuous engine
(``repro_torch.serve.scheduler``) at full occupancy.

Set-up draws the weights on the device from the seed, then admits every
slot's prompt one request at a time through the engine's prefill into a
slot (its caches installed in the slot's row), and warms up.  Prompt
lengths are log-uniform between ``prompt_min`` and ``prompt_max``, tokens
uniform over the vocabulary, both from the seed.  A unit of work is
``steps`` decode steps of every slot from the set-up's caches, through
``LanguageModel.decode_step`` with a position per row, greedy, the tokens
kept on the device: each unit decodes the same positions, rewrites the
attention caches' rows there before reading them, and reads the set-up's
Mamba-2 states, which decode does not write.  The logits of ``check_rows``
rows (the longest prompt and others from the seed) are copied into a
buffer inside the unit.

The check, after :meth:`App.finish`: the weights drawn again from the
seed, the plain float32 reference (``perfbench.reference.granite``) runs
each checked row's prompt and its ``steps`` greedy tokens, and every
step's logits of the last unit are held to it (``logit_err``, the largest
relative L2 norm); and the MoE layers' dropped assignments over all their
assignments since set-up (``dropped_share``, by the program's counters).
"""
from __future__ import annotations

import math

import numpy as np

from perfbench import counts, lm_counts
from perfbench.reference import granite as reference

#: What the ``logit_raised`` fault adds to one logit a step.
BUMP = 8.0


def arch_of(c: dict):
    """The port's ``ArchConfig`` of the configuration's file ``c``; raises
    where the port lacks a field it needs."""
    from repro_torch.models.config import ArchConfig
    types = c["layer_types"]
    attn = [i for i, t in enumerate(types) if t == "attention"]
    period = attn[1] - attn[0] if len(attn) > 1 else len(types)
    if any((t == "attention") != (i % period == attn[0] % period)
           for i, t in enumerate(types)):
        raise ValueError(f"{c['name']}: layer_types has no period")
    return ArchConfig(
        name=c["name"], family="hybrid", n_layers=c["n_layers"],
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_ff=c["intermediate_size"],
        vocab_size=c["vocab_size"], tie_embeddings=c["tie_word_embeddings"],
        norm_eps=c["rms_norm_eps"], qkv_bias=c["attention_bias"],
        n_experts=c["num_local_experts"],
        experts_per_token=c["num_experts_per_tok"], moe_dropless=True,
        shared_ff=c["shared_intermediate_size"],
        ssm_state=c["mamba_d_state"], ssm_conv=c["mamba_d_conv"],
        ssm_expand=c["mamba_expand"], ssm_version=2,
        ssm_heads=c["mamba_n_heads"], ssm_head_dim=c["mamba_d_head"],
        ssm_groups=c["mamba_n_groups"], ssm_chunk=c["mamba_chunk_size"],
        attn_period=period, attn_offset=attn[0] % period,
        rope=c["position_embedding_type"] != "nope",
        rope_theta=float(c["rope_theta"]),
        attn_scale=c["attention_multiplier"],
        embedding_multiplier=float(c["embedding_multiplier"]),
        residual_multiplier=c["residual_multiplier"],
        logits_scaling=float(c["logits_scaling"]), dtype=c["dtype"],
        remat=False)


class App:
    """``dtype``, where given, is a type every weight is rounded through
    (the control's); the check's reference takes the weights unrounded."""

    def __init__(self, torch, cfg: dict, traffic: dict, seed: int,
                 device: str, dtype=None):
        self.torch = torch
        self.device = torch.device(device)
        self.c, self.arch = cfg, arch_of(cfg)
        self.round_to = dtype
        self.slots, self.steps = traffic["slots"], traffic["steps"]
        self.max_len = traffic["max_len"]
        self.trace_units = traffic["trace_units"]
        self.warmup_units = traffic["warmup_units"]
        rng = np.random.default_rng(seed)
        lo, hi = traffic["prompt_min"], traffic["prompt_max"]
        self.lengths = np.clip(np.rint(np.exp(rng.uniform(
            math.log(lo), math.log(hi), self.slots))), lo, hi).astype(int)
        if self.lengths.max() + self.steps > self.max_len:
            raise ValueError(f"max_len {self.max_len} holds no prompt of "
                             f"{self.lengths.max()} and {self.steps} steps")
        longest = int(self.lengths.argmax())
        others = np.delete(np.arange(self.slots), longest)
        self.rows = [longest] + sorted(int(r) for r in rng.choice(
            others, traffic["check_rows"] - 1, replace=False))
        self.weight_seed = int(rng.integers(2 ** 62))
        self.token_seed = int(rng.integers(2 ** 62))
        kinds = lm_counts.layer_kinds(cfg)
        self.n_mamba = kinds.count("mamba")
        self.step_least_s = sum(lm_counts.least_s(
            lm_counts.step_bytes(cfg, self.slots, self.lengths + t),
            lm_counts.step_ops(cfg, self.slots, self.lengths + t))
            for t in range(self.steps)) / self.steps

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def _model(self, rounded: bool):
        """The model, its weights drawn from the seed; ``rounded``: each
        rounded through the control's type."""
        from repro_torch.models import make_model
        torch = self.torch
        gen = torch.Generator(device=self.device).manual_seed(
            self.weight_seed)
        model = make_model(self.arch, use_kernel=self.device.type == "cuda",
                           device=self.device, generator=gen)
        if rounded and self.round_to is not None:
            for p in model.parameters():
                p.copy_(p.to(self.round_to).to(p.dtype))
        return model

    def _prompts(self) -> list:
        rng = np.random.default_rng(self.token_seed)
        toks = rng.integers(0, self.c["vocab_size"], int(self.lengths.sum()),
                            dtype=np.int32)
        return np.split(toks, np.cumsum(self.lengths)[:-1])

    def setup(self):
        from repro_torch.models import moe
        from repro_torch.serve.scheduler import ContinuousEngine, Request
        torch = self.torch
        self.prompts = self._prompts()
        with torch.inference_mode():
            self.model = self._model(rounded=True)
            eng = ContinuousEngine(self.model, n_slots=self.slots,
                                   max_len=self.max_len)
            first = []
            for slot, toks in enumerate(self.prompts):
                logits = eng._prefill_into_slot(
                    Request(tokens=toks, max_new_tokens=self.steps,
                            rid=slot), slot)
                first.append(logits[0, -1].argmax())
            self.caches = eng.caches
            del eng
            self.tok0 = torch.stack(first)[:, None]
            self.pos0 = torch.as_tensor(self.lengths, device=self.device)
            self.rows_t = torch.as_tensor(self.rows, device=self.device)
            self.out_logits = torch.empty(
                (self.steps, len(self.rows), self.c["vocab_size"]),
                dtype=torch.float32, device=self.device)
            self.out_tokens = torch.empty((len(self.rows), self.steps),
                                          dtype=torch.int64,
                                          device=self.device)
        for _ in range(self.warmup_units):
            self.unit()
        self.sync()
        self.counted = moe.snapshot()

    def unit(self) -> int:
        """Enqueue ``steps`` decode steps of every slot; returns them."""
        torch = self.torch
        with torch.inference_mode():
            caches, tok = list(self.caches), self.tok0
            for t in range(self.steps):
                logits, caches = self.model.decode_step(
                    caches, {"tokens": tok}, self.pos0 + t, release=True)
                out = logits[:, 0]
                self.out_logits[t].copy_(out.index_select(0, self.rows_t))
                self.out_tokens[:, t].copy_(tok[:, 0].index_select(
                    0, self.rows_t))
                tok = out.argmax(-1, keepdim=True)
            del caches
        return self.steps

    def mamba2_state_calls(self, units: int) -> int:
        """``lm.mamba2.state`` calls in ``units`` units."""
        return self.n_mamba * self.steps * units

    def mamba2_state_least_s(self, units: int) -> float:
        """The least time of those calls: each one's state read and written
        once, x, dt, B and C in and y out (``perfbench.lm_counts``)."""
        return self.mamba2_state_calls(units) * lm_counts \
            .mamba2_state_call_bytes(self.c, self.slots) / counts.HBM_BYTES_S

    def moe_least_s(self, units: int) -> float:
        """The least time of the MoE layers in ``units`` units: each
        layer's weights a step, every expert touched once (2,560
        assignments a step reach all 72), with the shared expert and the
        router."""
        return self.c["n_layers"] * self.steps * units * lm_counts \
            .moe_weight_bytes(self.c) / counts.HBM_BYTES_S

    def finish(self):
        """Free the program's state but the outputs the check reads."""
        del self.model, self.caches, self.tok0, self.pos0
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def check(self, limits: dict) -> tuple:
        """Each checked row's logits at every step of the last unit against
        the reference's over its prompt and greedy tokens (the largest
        relative L2 norm), and the share of dropped assignments."""
        from repro_torch.models import convert, moe
        torch = self.torch
        n, lost = moe.since(self.counted)
        share = lost / n if n else float("nan")
        got = self.out_logits.transpose(0, 1)              # (rows, steps, V)
        fed = self.out_tokens.cpu().numpy()
        with torch.inference_mode():
            model = self._model(rounded=False)
            weights = convert.plain_weights(model)
            plain = convert.plain_cfg(model.cfg)
            errs = []
            for i, row in enumerate(self.rows):
                seq = torch.as_tensor(np.concatenate(
                    [self.prompts[row], fed[i]]), device=self.device).long()
                ref = reference.forward(seq, weights, plain, last=self.steps)
                errs += ((got[i] - ref).norm(dim=-1)
                         / ref.norm(dim=-1)).cpu().tolist()
                del ref
            del model, weights
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        lim_l, lim_d = limits["logit_err"], limits["dropped_share"]
        worst = float("nan") if any(e != e for e in errs) else max(errs)
        failed = sum(not e <= lim_l for e in errs) + (not share <= lim_d)
        return ({"logit_err": (worst, lim_l), "dropped_share": (share, lim_d)},
                len(errs), failed)


# Faults planted in the timed path, each of which a check must catch:
# ``plant(app, mp)`` with ``mp`` a ``pytest.MonkeyPatch``.

def _state_unchanged(app, mp):
    """Every Mamba-2 decode returns the state it was given."""
    from repro_torch.models import mamba2
    step = mamba2.mamba2_decode

    def stale(p, x, cfg, state):
        return step(p, x, cfg, state)[0], state
    mp.setattr(mamba2, "mamba2_decode", stale)


def _state_zeroed(app, mp):
    """Every Mamba-2 decode starts from a zero state."""
    from repro_torch.models import mamba2
    step = mamba2.mamba2_decode

    def zeroed(p, x, cfg, state):
        return step(p, x, cfg, state._replace(
            ssm=app.torch.zeros_like(state.ssm)))
    mp.setattr(mamba2, "mamba2_decode", zeroed)


def _no_shared(app, mp):
    """The shared expert left out of every MoE layer."""
    from repro_torch.models import moe
    mp.setattr(moe, "shared_expert",
               lambda p, x, cfg: app.torch.zeros_like(x))


def _logit_raised(app, mp):
    """One logit of every decode step raised by :data:`BUMP`."""
    setup = app.setup

    def wrapped():
        setup()
        decode = app.model.decode_step

        def raised(*args, **kwargs):
            logits, caches = decode(*args, **kwargs)
            logits[:, :, 123] += BUMP
            return logits, caches
        mp.setattr(app.model, "decode_step", raised)
    mp.setattr(app, "setup", wrapped)


FAULTS = {"state_unchanged": _state_unchanged, "state_zeroed": _state_zeroed,
          "no_shared": _no_shared, "logit_raised": _logit_raised}
