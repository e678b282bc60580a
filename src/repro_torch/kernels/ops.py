"""Attention dispatch, the counterpart of ``repro.kernels.ops``: the
absorbed-MLA shapes (16, 8, 4, 2 or 1 query heads on one latent head, Dk
576, Dv 512: the whole deepseek-v2-lite and a rank of it on a model axis
of 2, 4, 8 or 16) go to the MLA kernels at any query length (the decode step and the speculative
verify), any other single query token to the decode kernel, everything else
to the prefill (flash) kernel. ``plain=True`` takes the kernels' plain
versions on any device (the kernel-versus-plain parity runs on the card).
``decode_attention_piece`` is the decode over one rank's piece of a
sequence-cut cache: the MLA kernels' piece mode at the absorbed-MLA shape
(``mla_attention_piece``, T >= 1 query positions), else the decode
kernel's (``kernels.decode_attention``, one query position)."""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import mla_attention as _mla
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.mla_attention import is_mla_shape, mla_attention, mla_attention_plain


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    q_offset=0, kv_len=None, scale=None, plain=False):
    if is_mla_shape(q, k, v):
        fn = mla_attention_plain if plain else mla_attention
        return fn(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len, window=window,
                  softcap=softcap, scale=scale)
    if q.shape[1] == 1:
        fn = decode_attention_plain if plain else decode_attention
        return fn(q, k, v, q_offset=q_offset, kv_len=kv_len, window=window,
                  softcap=softcap, scale=scale)
    fn = flash_attention_plain if plain else _flash
    return fn(q, k, v, causal=causal, window=window, softcap=softcap,
              q_offset=q_offset, kv_len=kv_len, scale=scale)


def decode_attention_piece(q, k, v, *, k_start, q_offset=0, kv_len=None, window=None,
                           softcap=None, scale=None, causal=False, plain=False):
    """Query rows against a cache piece whose first key sits at global
    position ``k_start``: (o fp32, lse fp32) for
    ``sharding.collectives``' merges. The MLA shapes, and any call with
    ``causal`` (T >= 1 rows, each kept up to its own position: MLA's
    verify), take the MLA kernels' piece mode; any other shape one query
    token per row against the decode kernel's, its bound ``kv_len``."""
    kw = dict(k_start=k_start, q_offset=q_offset, kv_len=kv_len, window=window,
              softcap=softcap, scale=scale)
    if causal or is_mla_shape(q, k, v):
        fn = _mla.mla_attention_piece_plain if plain else _mla.mla_attention_piece
        return fn(q, k, v, causal=causal, **kw)
    fn = _decode.decode_attention_piece_plain if plain else _decode.decode_attention_piece
    return fn(q, k, v, **kw)
