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
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models import model as model_lib
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
        self.prefill_calls = 0
        self.decode_calls = 0
        self.verify_calls = 0

    def _ids(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).long()

    def _frames(self, enc_inputs):
        if self.cfg.is_encoder_decoder and enc_inputs is None:
            raise ValueError(f"{self.name}: an encoder-decoder prefill needs enc_inputs")
        return None if enc_inputs is None else torch.as_tensor(np.asarray(enc_inputs),
                                                               device=self.device)

    def _prefill(self, cache, tokens, pad_mask=None, enc_inputs=None):
        self.prefill_calls += 1
        logits, cache = model_lib.prefill(self.params, self.cfg, tokens, cache, self.ctx,
                                          last_only=True, pad_mask=pad_mask,
                                          enc_inputs=enc_inputs)
        return logits[:, -1], cache

    def _decode(self, cache, token, pos, enc_len=None):
        self.decode_calls += 1
        logits, cache = model_lib.decode_step(self.params, self.cfg, token, cache, pos,
                                              self.ctx, enc_len=enc_len)
        return logits[:, -1], cache

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, max_new: int, temperature: float = 0.0,
                 seed: int = 0, enc_inputs=None) -> np.ndarray:
        """prompts (B, S) equal-length. Greedy (T=0) or sampled decode (one
        generator seeded by ``seed``, shared across rows). ``enc_inputs``
        (B, T_frames, d_model) for encoder-decoder models: the reference
        path's cross cache holds exactly T_frames, unmasked."""
        B, S = prompts.shape
        frames = self._frames(enc_inputs)
        cache = model_lib.init_cache(self.cfg, B, self.max_len, self.device,
                                     enc_len=0 if frames is None else frames.shape[1])
        logits, cache = self._prefill(cache, self._ids(prompts), enc_inputs=frames)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        out = np.zeros((B, max_new), np.int32)
        tok = self._pick(logits, temperature, gen)
        for i in range(max_new):
            out[:, i] = tok[:, 0].cpu().numpy()
            if i == max_new - 1:
                break
            logits, cache = self._decode(cache, tok, S + i)
            tok = self._pick(logits, temperature, gen)
        return out

    @staticmethod
    def _pick(logits, temperature, gen):
        if temperature <= 0.0:
            return logits.argmax(dim=-1, keepdim=True)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)

    # ---- continuous-batching primitives (slot-pool cache) ----

    def init_pool(self, max_slots: int):
        """Preallocated cache with one row per request slot (plus a
        ``max_enc_len`` cross-attention region for encoder-decoder
        models)."""
        return model_lib.init_cache(self.cfg, max_slots, self.max_len, self.device,
                                    enc_len=self.max_enc_len)

    def prefill_one(self, prompt: np.ndarray, enc_inputs=None):
        """Prefill one request at its exact length. Returns (last-position
        logits (1,V), batch-1 cache to scatter into a slot)."""
        return self.prefill_batch(prompt[None],
                                  None if enc_inputs is None else np.asarray(enc_inputs)[None])

    @torch.no_grad()
    def prefill_batch(self, prompts: np.ndarray, enc_inputs=None, pad_mask=None):
        """Batched admission prefill: ``prompts`` (G, S) equal-length (the
        caller pads G to a pow2 bucket), ``enc_inputs`` (G, T_frames,
        d_model) for encoder-decoder models. Returns (last-position logits
        (G,V), batch-G cache whose rows scatter into slots via
        ``write_slots``; its cross region is ``max_enc_len`` long).
        ``pad_mask`` (G, S) bool marks the valid tokens of LEFT-padded
        prompts bucketed to a shared length — pure-SSM stacks only (masked
        positions neither write into nor decay the scan state, so the caches
        match exact-length prefill)."""
        if pad_mask is not None and self.cfg.is_encoder_decoder:
            # the decoder's attention layers would mis-serve left-padded
            # prompts: refuse as the stack does
            raise ValueError("pad_mask is only supported for pure-SSM stacks, not "
                             "encoder-decoder models")
        frames = self._frames(enc_inputs)
        cache = model_lib.init_cache(self.cfg, prompts.shape[0], self.max_len, self.device,
                                     enc_len=self.max_enc_len)
        mask = None if pad_mask is None else torch.as_tensor(np.asarray(pad_mask),
                                                             device=self.device)
        return self._prefill(cache, self._ids(prompts), mask, frames)

    def write_slot(self, pool_cache, one_cache, slot: int):
        return model_lib.write_cache_slot(pool_cache, one_cache, slot)

    def write_slots(self, pool_cache, group_cache, slots: np.ndarray):
        """Scatter a batched prefill cache into the rows named by ``slots``;
        out-of-range entries (pow2 batch padding) are dropped."""
        return model_lib.write_cache_slots(pool_cache, group_cache, slots)

    @torch.no_grad()
    def decode_pool(self, pool_cache, tokens: np.ndarray, pos: np.ndarray, enc_len=None):
        """One ragged decode step over the whole slot pool. ``tokens``
        (max_slots,1), ``pos`` (max_slots,) per-slot write positions,
        ``enc_len`` (max_slots,) per-slot encoder lengths for
        encoder-decoder models (each row's cross-attention masked to its
        own region; 0 on a slot never admitted). Returns (greedy next tokens
        (max_slots,) np.int32, logits (max_slots, V) for per-slot sampling,
        cache)."""
        el = None if enc_len is None else torch.as_tensor(np.asarray(enc_len, np.int32),
                                                          device=self.device)
        logits, pool_cache = self._decode(pool_cache, self._ids(tokens),
                                          torch.as_tensor(np.asarray(pos, np.int32),
                                                          device=self.device), el)
        next_tok = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
        return next_tok, logits, pool_cache

    @torch.no_grad()
    def decode_verify(self, pool_cache, tokens: np.ndarray, pos: np.ndarray):
        """Multi-position ragged decode over the slot pool, the speculative
        verify and draft catch-up primitive. ``tokens`` (max_slots, T), T > 1,
        feed positions pos..pos+T-1 per row against the cache (writes past
        the cache drop; stale entries past a slot's frontier are causally
        masked, see ``gqa_decode``). Returns (greedy tokens (max_slots, T)
        np.int32, logits (max_slots, T, V), cache)."""
        self.verify_calls += 1
        logits, pool_cache = model_lib.decode_step(
            self.params, self.cfg, self._ids(tokens), pool_cache,
            torch.as_tensor(np.asarray(pos, np.int32), device=self.device), self.ctx)
        return logits.argmax(dim=-1).to(torch.int32).cpu().numpy(), logits, pool_cache
