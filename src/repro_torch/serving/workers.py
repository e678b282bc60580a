"""Per-model serving worker: prefill/decode against a preallocated KV cache,
batch generation, and the slot-pool primitives the continuous engine
drives — the counterpart of ``repro.serving.workers.ModelWorker``.

The worker runs on the device its params lie on. Caches are updated in
place. ``prefill_calls``, ``decode_calls`` and ``verify_calls`` count the
model passes, so a run can check how often each kernel must have launched:
one prefill attention or SSD scan launch per layer per prefill, one decode
attention launch per attention layer per single-token pass, one prefill
(flash) attention launch per attention layer per multi-position pass (the
speculative verify and the draft's catch-up, ``decode_verify``).

Sharded serving: when the ``ExecContext`` carries a mesh, the worker takes
the rule table's placement of its params at construction
(``sharding.placement.plan_params``, its decisions tallied on
``shard_report``, the table kept as ``param_shardings``), cuts its params
to this rank's shard once (``convert.shard_params``, which cuts each leaf
where that table puts the model axis; params drawn as the rank's shard
already are kept), and allocates every cache as this rank's piece of the
activation rules' placement, one placement per (batch, enc_len) shape in
``_cache_shardings``. A mesh of one takes this path with every tensor
whole and no collective: it computes exactly what ``mesh=None`` computes.

On a model axis of M > 1 every rank runs this worker, and the engine
around it, in a process of its own, and the ranks need no broadcast of
tokens: each decision (scheduling, admission, sampling, retirement) is a
function of the requests, the seeds and the simulated device's clock and
predictions, which every rank holds alike, and of the logits, which every
rank holds whole and bit-identical (the LM head's vocab slices are
all-gathered, and every activation before it is a sum that the all-reduce
hands every rank in the same bits). The wall clock enters a decision only
through an admission SLO or a request deadline, both off by default (under
``run_trace`` the clock is virtual, so even those agree). So the ranks
take the same decisions in the same order and issue the same
collectives.

Data-parallel serving (a data group of D > 1 ranks: the data axis, or
the pod and data axes together). A slot pool that D divides is split on
its rows: each data rank holds ``max_slots / D`` rows, slots [d n, (d+1) n)
(the cache rule's ``batch_ok``), and ``decode_pool`` decodes only those
rows. A prefill group (``prefill_batch`` with the group's ``slots``) is
split where each data rank owns the same number of its slots, each rank
running the rows whose slots it owns, and otherwise replicated, every rank
running the whole group (``ExecContext.batch_split`` False); each rank
writes only the slots it owns (``write_slots``), draws the tokens of its
own rows (greedy or per-request streams, ``group_tokens`` /
``slot_tokens``), and the tokens are all-gathered over the data group, so
every rank holds every token and takes the same admission and retirement
decisions.

A pool that D does not divide is cut on its K/V sequence instead, the
rule table's fallback (``placement.plan_cache``, ``pool_seq``): every rank
holds every row, its piece of the K/V leaves' and the MLA latent's
positions (over the data group, and the kv group at M > 1) and every other
leaf whole, and runs every row of every pass with ``ExecContext.kv_seq``
(``models.attention``: its writes land in its piece, its decode attends
over its piece and the pieces' softmax states merge over the kv group,
then over the data group).
Every rank then computes every row's logits in the same bits and draws
every token itself, so no token is gathered.

``generate`` (the bucketed mode) takes the same two layouts per batch: B
rows that D divides are split, each rank running its B / D rows and the
tokens all-gathered; otherwise the batch's cache is cut on its sequence
and every rank runs every row. Either way every data rank runs every pass
at the same shapes, so FSDP weights and the 2-D MoE gather over the data
group in step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import convert
from repro_torch.models import model as model_lib
from repro_torch.serving.sampling import _sample_rows
from repro_torch.sharding import collectives
from repro_torch.sharding import partition_specs as ps
from repro_torch.sharding import placement
from repro_torch.sharding.context import ExecContext


class ModelWorker:
    def __init__(self, name: str, cfg, params, max_len: int = 512,
                 ctx: ExecContext = ExecContext(), max_enc_len: Optional[int] = None):
        self.name = name
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.ctx = ctx
        # encoder-decoder slot pools preallocate the cross-attention cache
        # region at this length; decoder-only models carry no encoder region
        self.max_enc_len = (max_enc_len if max_enc_len is not None
                            else (max_len if cfg.is_encoder_decoder else 0))
        self.device = params.embedding.device
        # mesh-aware placement: params once per worker, caches per (batch,
        # enc_len) shape as they are allocated
        self.mesh = ctx.mesh
        self.shard_report = None
        self.param_shardings = None
        self._cache_shardings: dict = {}
        if self.mesh is not None:
            self.shard_report = ps.ShardingReport()
            plan = placement.plan_params(cfg, ctx, report=self.shard_report)
            self.param_shardings = plan.specs
            self.params = convert.shard_params(params, ctx, plan=plan)
        self.prefill_calls = 0
        self.decode_calls = 0
        self.verify_calls = 0
        # data-parallel serving: D data ranks, this one's index, and the rows
        # of the last prefill group it ran (module docstring)
        self.data_parallel = ctx.batch_parallel
        self.data_rank = ctx.data_rank if self.data_parallel > 1 else 0
        self._held: Optional[List[int]] = None
        # the context of a cache cut on its K/V sequence over the data group,
        # and whether the slot pool is one (``init_pool``; module docstring)
        self.seq_ctx = (dataclasses.replace(ctx, batch_split=False, kv_seq=max_len)
                        if self.data_parallel > 1 else None)
        self.pool_seq = False

    @property
    def rows_split(self) -> bool:
        """Whether the data ranks hold other rows of the slot pool."""
        return self.data_parallel > 1 and not self.pool_seq

    def _new_cache(self, batch: int, enc_len: int, rows_split: bool = True,
                   kv_seq: bool = False):
        """Allocate a cache; under a mesh, every leaf holds this rank's
        piece of the activation rules' placement (``placement.plan_cache``:
        the K/V leaves this rank's kv heads, the rows this data rank's
        slots, or the K/V sequence's piece where D does not divide
        ``batch``). ``rows_split=False``: all ``batch`` rows on this rank
        (a prefill group's rows); ``kv_seq``: the K/V sequence cut, every
        row here, whatever D and ``batch`` are (a prefill group of a
        sequence-cut pool)."""
        if self.mesh is None:
            return model_lib.init_cache(self.cfg, batch, self.max_len, self.device,
                                        enc_len=enc_len)
        if self.data_parallel > 1 and (not rows_split or kv_seq):
            specs = placement.plan_cache(self.cfg, self.ctx, batch, self.max_len, enc_len,
                                         rows_split=rows_split, kv_seq=kv_seq)
        else:
            specs = self._cache_shardings.get((batch, enc_len))
            if specs is None:
                specs = self._cache_shardings[(batch, enc_len)] = placement.plan_cache(
                    self.cfg, self.ctx, batch, self.max_len, enc_len, report=self.shard_report)
        return placement.init_placed_cache(self.cfg, self.ctx, specs, batch, self.max_len,
                                           self.device, enc_len)

    # ---- data-parallel rows ----

    def _slot_owner(self, slot: int, n_slots: int) -> int:
        """The data rank that holds pool slot ``slot`` (D for none)."""
        if not 0 <= slot < n_slots:
            return self.data_parallel
        return slot // (n_slots // self.data_parallel)

    def pool_rows(self, n_slots: int):
        """(first slot, number of slots) of the slot pool's rows this rank
        holds: all of them unless the data ranks split the rows."""
        if not self.rows_split:
            return 0, n_slots
        n = n_slots // self.data_parallel
        return self.data_rank * n, n

    def gather_rows(self, idx: Sequence[int], rows, n: int, W: int) -> np.ndarray:
        """Every rank's non-negative integer ``rows`` (len(idx), W) of its
        rows ``idx`` (of ``n``), all-gathered over the data group: (n, W)
        in row order."""
        mine = torch.full((n, W), -1, dtype=torch.int64, device=self.device)
        if len(idx):
            mine[torch.as_tensor(list(idx), device=self.device)] = torch.as_tensor(
                np.asarray(rows, np.int64).reshape(len(idx), W), device=self.device)
        every = collectives.all_gather(mine[None], 0, self.data_parallel, self.ctx.data_group)
        return every.max(dim=0).values.cpu().numpy()

    def _gather_tokens(self, idx: Sequence[int], toks: Sequence[int], n: int) -> List[int]:
        """Every rank's tokens of its rows ``idx`` (of ``n``), all-gathered
        over the data group: the n tokens in row order."""
        return [int(t) for t in self.gather_rows(idx, [[int(t)] for t in toks], n, 1)[:, 0]]

    def group_tokens(self, logits, slots: Sequence[int], n_slots: int,
                     pick: Callable) -> List[int]:
        """The tokens of a prefill group's G = len(slots) requests from the
        last ``prefill_batch``'s logits: ``pick(rows, idx)`` draws the
        tokens of group rows ``idx`` from their logits ``rows``. At D > 1
        each rank draws those of the slots it owns and all-gathers them."""
        G = len(slots)
        if not self.rows_split:
            return list(pick(logits[:G], list(range(G))))
        pos = {i: j for j, i in enumerate(self._held)}  # the rank's rows hold its slots
        idx = [i for i in range(G) if self._slot_owner(int(slots[i]), n_slots) == self.data_rank]
        toks = pick(logits[[pos[i] for i in idx]], idx) if idx else []
        return self._gather_tokens(idx, toks, G)

    def slot_tokens(self, logits, slots: Sequence[int], n_slots: int,
                    pick: Callable) -> List[int]:
        """The tokens of the pool slots ``slots`` from ``decode_pool``'s
        logits, ``pick`` as in ``group_tokens``."""
        if not self.rows_split:
            return list(pick(logits[list(slots)], list(range(len(slots)))))
        n = n_slots // self.data_parallel
        lo = self.data_rank * n
        idx = [i for i, s in enumerate(slots) if lo <= s < lo + n]
        toks = pick(logits[[slots[i] - lo for i in idx]], idx) if idx else []
        return self._gather_tokens(idx, toks, len(slots))

    def _ids(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).long()

    def _frames(self, enc_inputs):
        if self.cfg.is_encoder_decoder and enc_inputs is None:
            raise ValueError(f"{self.name}: an encoder-decoder prefill needs enc_inputs")
        return None if enc_inputs is None else torch.as_tensor(np.asarray(enc_inputs),
                                                               device=self.device)

    def _prefill(self, cache, tokens, pad_mask=None, enc_inputs=None, ctx=None):
        self.prefill_calls += 1
        logits, cache = model_lib.prefill(self.params, self.cfg, tokens, cache, ctx or self.ctx,
                                          last_only=True, pad_mask=pad_mask,
                                          enc_inputs=enc_inputs)
        return logits[:, -1], cache

    def _decode(self, cache, token, pos, enc_len=None, ctx=None):
        self.decode_calls += 1
        logits, cache = model_lib.decode_step(self.params, self.cfg, token, cache, pos,
                                              ctx or self.ctx, enc_len=enc_len)
        return logits[:, -1], cache

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, max_new: int, enc_inputs=None,
                 temperature: float = 0.0, seed: int = 0, row_keys=None,
                 pad_mask=None) -> np.ndarray:
        """prompts (B, S) equal-length: one prefill, then ``max_new - 1``
        position-synchronous decode steps. Greedy (T=0) or sampled decode.

        ``row_keys`` (B,) per-request streams (``sampling.stream_key``):
        token i of row b is token i of stream ``row_keys[b]``, the draw the
        continuous engine makes for that request, so both serving modes
        emit identical sampled tokens. ``None`` keeps one generator seeded
        by ``seed``, shared across rows.

        ``enc_inputs`` (B, T_frames, d_model) for encoder-decoder models:
        the cross cache holds exactly T_frames, unmasked. ``pad_mask`` (B,
        S) bool marks the valid tokens of LEFT-padded prompts bucketed to a
        shared length — pure-SSM stacks only (the scan passes masked
        positions through untouched).

        On a data group of D > 1 (module docstring) the batch's rows are
        split where D divides B (each rank runs its B / D rows, the tokens
        all-gathered; with one shared generator the logits are gathered
        and every rank draws every row), else its cache is cut on its K/V
        sequence and every rank runs every row; every rank returns every
        row's tokens."""
        B, S = prompts.shape
        if pad_mask is not None and self.cfg.is_encoder_decoder:
            raise ValueError("pad_mask is only supported for pure-SSM stacks, not "
                             "encoder-decoder models")
        D = self.data_parallel
        seq, split = D > 1 and B % D != 0, D > 1 and B % D == 0
        ctx = self.seq_ctx if seq else self.ctx
        rows = slice(None)
        if split:  # this rank's rows
            n = B // D
            rows = slice(self.data_rank * n, (self.data_rank + 1) * n)
        frames = self._frames(None if enc_inputs is None else np.asarray(enc_inputs)[rows])
        cut = seq or self.ctx.kv_group(self.cfg) > 1  # a sequence-cut cross cache
        enc_len = None if frames is None or not cut else frames.shape[1]
        cache = self._new_cache(B, 0 if frames is None else frames.shape[1])
        mask = None if pad_mask is None else torch.as_tensor(np.asarray(pad_mask)[rows],
                                                             device=self.device)
        logits, cache = self._prefill(cache, self._ids(np.asarray(prompts)[rows]), mask, frames,
                                      ctx)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        keys = None if row_keys is None else list(row_keys)[rows]

        def pick(logits, i):  # every row's tokens (B, 1)
            if not split:
                return self._pick(logits, temperature, gen, keys, i)
            grp = self.ctx.data_group
            if temperature > 0.0 and keys is None:  # one generator over every row
                return self._pick(collectives.all_gather(logits, 0, D, grp), temperature, gen,
                                  None, i)
            return collectives.all_gather(self._pick(logits, temperature, gen, keys, i), 0, D,
                                          grp)

        out = np.zeros((B, max_new), np.int32)
        tok = pick(logits, 0)
        for i in range(max_new):
            out[:, i] = tok[:, 0].cpu().numpy()
            if i == max_new - 1:
                break
            logits, cache = self._decode(cache, tok[rows], S + i, enc_len, ctx)
            tok = pick(logits, i + 1)
        return out

    @staticmethod
    def _pick(logits, temperature, gen, row_keys=None, token_idx=0):
        if temperature <= 0.0:
            return logits.argmax(dim=-1, keepdim=True)
        if row_keys is not None:
            toks = _sample_rows(row_keys, [token_idx] * len(row_keys), logits, temperature)
            return torch.as_tensor(toks, device=logits.device).long()[:, None]
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)

    # ---- continuous-batching primitives (slot-pool cache) ----

    def init_pool(self, max_slots: int):
        """Preallocated cache with one row per request slot (plus a
        ``max_enc_len`` cross-attention region for encoder-decoder
        models), placed under the activation rules when the worker carries
        a mesh: at a data group of D > 1 split on its rows where D divides
        ``max_slots``, else cut on its K/V sequence (``pool_seq``; module
        docstring)."""
        self.pool_seq = self.data_parallel > 1 and max_slots % self.data_parallel != 0
        return self._new_cache(max_slots, self.max_enc_len)

    def prefill_one(self, prompt: np.ndarray, enc_inputs=None):
        """Prefill one request at its exact length. Returns (last-position
        logits (1,V), batch-1 cache to scatter into a slot)."""
        return self.prefill_batch(prompt[None],
                                  None if enc_inputs is None else np.asarray(enc_inputs)[None])

    @torch.no_grad()
    def prefill_batch(self, prompts: np.ndarray, enc_inputs=None, pad_mask=None,
                      slots=None, n_slots: Optional[int] = None):
        """Batched admission prefill: ``prompts`` (G, S) equal-length (the
        caller pads G to a pow2 bucket), ``enc_inputs`` (G, T_frames,
        d_model) for encoder-decoder models. Returns (last-position logits
        (G,V), batch-G cache whose rows scatter into slots via
        ``write_slots``; its cross region is ``max_enc_len`` long).
        ``pad_mask`` (G, S) bool marks the valid tokens of LEFT-padded
        prompts bucketed to a shared length — pure-SSM stacks only (masked
        positions neither write into nor decay the scan state, so the caches
        match exact-length prefill).

        At a data axis of D > 1, ``slots`` (G,) names each row's pool slot
        of a pool of ``n_slots`` (out of range: a padding row): the rank
        runs the rows of the slots it owns when every rank owns as many,
        else every row (module docstring), and the logits and cache hold
        those rows. A sequence-cut pool's group runs every row on every
        rank, its cache cut on its K/V sequence as the pool is."""
        if pad_mask is not None and self.cfg.is_encoder_decoder:
            # the decoder's attention layers would mis-serve left-padded
            # prompts: refuse as the stack does
            raise ValueError("pad_mask is only supported for pure-SSM stacks, not "
                             "encoder-decoder models")
        if self.pool_seq:
            frames = self._frames(enc_inputs)
            cache = self._new_cache(prompts.shape[0], self.max_enc_len, kv_seq=True)
            mask = None if pad_mask is None else torch.as_tensor(np.asarray(pad_mask),
                                                                 device=self.device)
            return self._prefill(cache, self._ids(prompts), mask, frames, self.seq_ctx)
        ctx = None
        if self.data_parallel > 1:
            if slots is None or n_slots is None:
                raise ValueError(f"{self.name}: a prefill at a data axis of "
                                 f"{self.data_parallel} needs the group's slots")
            owners = [self._slot_owner(int(s), n_slots) for s in slots]
            counts = np.bincount(owners, minlength=self.data_parallel + 1)
            if counts[self.data_parallel] == 0 and len(set(counts[:-1])) == 1:
                rows = [i for i, o in enumerate(owners) if o == self.data_rank]
            else:
                rows = list(range(len(slots)))
                ctx = dataclasses.replace(self.ctx, batch_split=False)
            self._held = rows
            prompts = np.asarray(prompts)[rows]
            enc_inputs = None if enc_inputs is None else np.asarray(enc_inputs)[rows]
            pad_mask = None if pad_mask is None else np.asarray(pad_mask)[rows]
        frames = self._frames(enc_inputs)
        cache = self._new_cache(prompts.shape[0], self.max_enc_len, rows_split=False)
        mask = None if pad_mask is None else torch.as_tensor(np.asarray(pad_mask),
                                                             device=self.device)
        return self._prefill(cache, self._ids(prompts), mask, frames, ctx)

    def write_slot(self, pool_cache, one_cache, slot: int):
        return model_lib.write_cache_slot(pool_cache, one_cache, slot)

    def write_slots(self, pool_cache, group_cache, slots: np.ndarray):
        """Scatter a batched prefill cache into the rows named by ``slots``;
        out-of-range entries (pow2 batch padding) are dropped. At D > 1 the
        cache holds the rows the last ``prefill_batch`` ran, and only the
        slots this rank owns are written, at their local rows."""
        if self.rows_split:
            n = next(iter(pool_cache.values())).shape[1]  # this rank's rows
            lo = self.data_rank * n
            local = np.full(len(self._held), n, np.int64)
            for j, i in enumerate(self._held):
                if lo <= int(slots[i]) < lo + n:
                    local[j] = int(slots[i]) - lo
            slots = local
        return model_lib.write_cache_slots(pool_cache, group_cache, slots)

    @torch.no_grad()
    def decode_pool(self, pool_cache, tokens: np.ndarray, pos: np.ndarray, enc_len=None):
        """One ragged decode step over the whole slot pool. ``tokens``
        (max_slots,1), ``pos`` (max_slots,) per-slot write positions,
        ``enc_len`` (max_slots,) per-slot encoder lengths for
        encoder-decoder models (each row's cross-attention masked to its
        own region; 0 on a slot never admitted). Returns (greedy next tokens
        (max_slots,) np.int32, logits (max_slots, V) for per-slot sampling,
        cache). At D > 1 on a row-split pool the rank decodes its own slots:
        the logits are those rows', the greedy tokens all-gathered for every
        slot; a sequence-cut pool's rank decodes every slot."""
        D = self.data_parallel
        if self.rows_split:
            lo, n = self.pool_rows(len(pos))
            rows = slice(lo, lo + n)
            tokens, pos = np.asarray(tokens)[rows], np.asarray(pos)[rows]
            enc_len = None if enc_len is None else np.asarray(enc_len)[rows]
        el = None if enc_len is None else torch.as_tensor(np.asarray(enc_len, np.int32),
                                                          device=self.device)
        logits, pool_cache = self._decode(pool_cache, self._ids(tokens),
                                          torch.as_tensor(np.asarray(pos, np.int32),
                                                          device=self.device), el,
                                          self.seq_ctx if self.pool_seq else None)
        next_tok = logits.argmax(dim=-1).to(torch.int32)
        if self.rows_split:
            next_tok = collectives.all_gather(next_tok, 0, D, self.ctx.data_group)
        return next_tok.cpu().numpy(), logits, pool_cache

    @torch.no_grad()
    def decode_verify(self, pool_cache, tokens: np.ndarray, pos: np.ndarray):
        """Multi-position ragged decode over the slot pool, the speculative
        verify and draft catch-up primitive. ``tokens`` (max_slots, T), T > 1,
        feed positions pos..pos+T-1 per row against the cache (writes past
        the cache drop; stale entries past a slot's frontier are causally
        masked, see ``gqa_decode``). Returns (greedy tokens (max_slots, T)
        np.int32, logits (max_slots, T, V), cache). On a row-split pool at
        D > 1 the rank verifies its own slots (``pool_rows``), and the
        tokens and logits are those rows'."""
        self.verify_calls += 1
        if self.rows_split:
            lo, n = self.pool_rows(len(pos))
            tokens, pos = np.asarray(tokens)[lo:lo + n], np.asarray(pos)[lo:lo + n]
        logits, pool_cache = model_lib.decode_step(
            self.params, self.cfg, self._ids(tokens), pool_cache,
            torch.as_tensor(np.asarray(pos, np.int32), device=self.device),
            self.seq_ctx if self.pool_seq else self.ctx)
        return logits.argmax(dim=-1).to(torch.int32).cpu().numpy(), logits, pool_cache
