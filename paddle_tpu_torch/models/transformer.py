"""Transformer encoder-decoder NMT, and the decoder-only LM behind the
token-serving engine.

The port's copy of ``paddle_tpu/models/transformer.py`` (reference model:
python/paddle/fluid/tests/unittests/transformer_model.py). ``build_train``
builds the NMT train step — forward, backward and Adam — with the same
ops, attrs and var names as the JAX package. Multi-head attention runs
through the fused scaled_dot_product_attention op, or with
``attention_impl="composed"`` through the user-level matmul -> (+mask)
-> softmax -> matmul chain that the rewrite pipeline's attention
outlining (analysis/rewrite.py) turns back into that op. The JAX
package's distributed embedding is not ported; context parallelism
(``seq_axis``) and ``tp_param_specs`` need a mesh and are not ported
either.

The decoder LM's three modes share one parameter set:

  "full"     [b, S]  causal forward over whole (padded) sequences,
             greedy next-token at each row's last real position — the
             re-forward baseline, and the bit-identity reference
  "prefill"  [1, S]  same forward for one request, but every layer
             also writes its K/V rows into that request's cache slot
  "decode"   [slots, 1]  one-token step: append K/V at each slot's
             position, attend over the first L cached rows (L = the
             cache-length bucket), emit the greedy next token

Weight sharing works by name: each program is built under
framework.isolated_name_scope() and makes the IDENTICAL sequence of
parameter-creating calls, so auto-generated param names line up and
every program reads the same scope tensors. KV caches are persistable
vars OUTSIDE the parameter set (kv_cache.* prefix), zero-filled by each
program's startup. The programs serialize to the same JSON as the JAX
package's.
"""
from __future__ import annotations

import numpy as np

from .. import framework, layers
from .. import optimizer as opt
from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper

#: name prefix of the persistable KV-cache state vars — the ONLY
#: persistable names a generation program may write
KV_CACHE_PREFIX = "kv_cache."


def multi_head_attention(q_in, k_in, v_in, d_model, n_head, mask=None,
                         dropout_rate=0.0, causal=False,
                         attention_impl="fused"):
    """attention_impl="fused" appends the single
    scaled_dot_product_attention op; "composed" builds the user-level
    matmul -> (+mask) -> softmax -> matmul chain instead, the program
    shape the rewrite pipeline's attention outlining exists for. The
    "tp_col_*"/"tp_row_*" name prefixes are the JAX package's Megatron
    pairing marks; the port keeps them so parameter names agree."""
    d_key = d_model // n_head
    q = layers.fc(q_in, size=d_model, num_flatten_dims=2,
                  bias_attr=False, name="tp_col_qkv")
    k = layers.fc(k_in, size=d_model, num_flatten_dims=2,
                  bias_attr=False, name="tp_col_qkv")
    v = layers.fc(v_in, size=d_model, num_flatten_dims=2,
                  bias_attr=False, name="tp_col_qkv")

    def split_heads(x):
        # [b, t, d_model] -> [b, n_head, t, d_key]
        reshaped = layers.reshape(x, [0, 0, n_head, d_key])
        return layers.transpose(reshaped, [0, 2, 1, 3])

    qh, kh, vh = split_heads(q), split_heads(k), split_heads(v)
    if attention_impl == "composed":
        if causal:
            raise ValueError(
                "attention_impl='composed' expresses causality and "
                "padding through the additive mask only; use the fused "
                "impl for the causal-attr / context-parallel paths")
        scores = layers.matmul(qh, kh, transpose_y=True,
                               alpha=float(1.0 / np.sqrt(d_key)))
        if mask is not None:
            scores = layers.elementwise_add(scores, mask)
        ctx_v = layers.matmul(layers.softmax(scores), vh)
    else:
        ctx_v = _sdpa_op(qh, kh, vh, mask, causal)
    merged = layers.transpose(ctx_v, [0, 2, 1, 3])
    merged = layers.reshape(merged, [0, 0, d_model])
    out = layers.fc(merged, size=d_model, num_flatten_dims=2,
                    bias_attr=False, name="tp_row_proj")
    if dropout_rate:
        out = layers.dropout(out, dropout_rate)
    return out


def ffn(x, d_model, d_inner, dropout_rate=0.0):
    hidden = layers.fc(x, size=d_inner, num_flatten_dims=2, act="relu",
                       name="tp_col_ffn")
    if dropout_rate:
        hidden = layers.dropout(hidden, dropout_rate)
    return layers.fc(hidden, size=d_model, num_flatten_dims=2,
                     name="tp_row_ffn")


def _add_norm(x, y, d_model):
    return layers.layer_norm(layers.elementwise_add(x, y),
                             begin_norm_axis=2)


def encoder_layer(x, d_model, n_head, d_inner, mask=None, dropout=0.0,
                  attention_impl="fused"):
    attn = multi_head_attention(x, x, x, d_model, n_head, mask, dropout,
                                attention_impl=attention_impl)
    x = _add_norm(x, attn, d_model)
    f = ffn(x, d_model, d_inner, dropout)
    return _add_norm(x, f, d_model)


def decoder_layer(x, enc_out, d_model, n_head, d_inner, self_mask=None,
                  cross_mask=None, dropout=0.0, self_causal=False,
                  attention_impl="fused"):
    self_attn = multi_head_attention(x, x, x, d_model, n_head, self_mask,
                                     dropout, causal=self_causal,
                                     attention_impl=attention_impl)
    x = _add_norm(x, self_attn, d_model)
    cross = multi_head_attention(x, enc_out, enc_out, d_model, n_head,
                                 cross_mask, dropout,
                                 attention_impl=attention_impl)
    x = _add_norm(x, cross, d_model)
    f = ffn(x, d_model, d_inner, dropout)
    return _add_norm(x, f, d_model)


def _position_encoding_table(max_len, d_model):
    pos = np.arange(max_len)[:, None].astype(np.float64)
    dim = np.arange(d_model)[None, :].astype(np.float64)
    angle = pos / np.power(10000.0, 2 * (dim // 2) / d_model)
    table = np.zeros((max_len, d_model), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


def embed(ids, vocab_size, d_model, max_len, pos_ids):
    word = layers.embedding(ids, size=[vocab_size, d_model])
    pe = layers.assign(_position_encoding_table(max_len, d_model))
    pos = layers.gather(pe, pos_ids)  # [t, d_model]
    return layers.elementwise_add(word, pos, axis=-1)


def _pad_attn_mask(ids, pad_id=0):
    """[b, t, 1] int ids -> additive mask [b, 1, 1, t]: -1e9 at pads."""
    is_pad = layers.cast(layers.equal(ids, pad_id * layers.ones_like(ids)),
                         "float32")                       # [b, t, 1]
    neg = layers.scale(is_pad, scale=-1e9)
    m = layers.transpose(neg, [0, 2, 1])                  # [b, 1, t]
    return layers.unsqueeze(m, [1])                       # [b, 1, 1, t]


def transformer(src_ids, trg_ids, trg_labels, pos_src, pos_trg,
                src_vocab=10000, trg_vocab=10000, max_len=64, n_layer=2,
                n_head=8, d_model=512, d_inner=2048, dropout=0.0,
                causal_mask=None, pad_id=0, attention_impl="fused"):
    """Encoder-decoder forward and the pad-masked mean token loss.
    Returns (loss [1], logits [b, t, trg_vocab])."""
    src_mask = _pad_attn_mask(src_ids, pad_id)
    enc = embed(src_ids, src_vocab, d_model, max_len, pos_src)
    for _ in range(n_layer):
        enc = encoder_layer(enc, d_model, n_head, d_inner, src_mask,
                            dropout, attention_impl=attention_impl)
    dec = embed(trg_ids, trg_vocab, d_model, max_len, pos_trg)
    self_mask = causal_mask
    if causal_mask is not None:
        trg_mask = _pad_attn_mask(trg_ids, pad_id)
        self_mask = layers.elementwise_add(trg_mask, causal_mask)
    for _ in range(n_layer):
        dec = decoder_layer(dec, enc, d_model, n_head, d_inner,
                            self_mask, src_mask, dropout,
                            attention_impl=attention_impl)
    logits = layers.fc(dec, size=trg_vocab, num_flatten_dims=2)
    tok_loss = layers.softmax_with_cross_entropy(logits, trg_labels)
    # Average only over non-pad target positions.
    nonpad = layers.cast(
        layers.logical_not(layers.equal(
            trg_labels, pad_id * layers.ones_like(trg_labels))), "float32")
    total = layers.reduce_sum(layers.elementwise_mul(tok_loss, nonpad))
    count = layers.elementwise_max(
        layers.reduce_sum(nonpad),
        layers.fill_constant([1], "float32", 1.0))
    loss = layers.elementwise_div(total, count)
    return loss, logits


def build_train(src_vocab=10000, trg_vocab=10000, max_len=64, n_layer=2,
                n_head=8, d_model=512, d_inner=2048, lr=1e-3,
                attention_impl="fused"):
    """The NMT train step: (main, startup, {"loss": loss}). Feeds:
    src_ids, trg_ids, trg_labels [b, max_len, 1] int64 (0 is the pad
    id) and pos_ids [max_len] int64. The decoder's self-attention mask
    is the target pad mask plus an assigned triu(-1e9) causal bias.
    attention_impl: "fused" or "composed" (multi_head_attention)."""
    main, startup = framework.Program(), framework.Program()
    with framework.program_guard(main, startup):
        src = layers.data("src_ids", [max_len, 1], dtype="int64")
        trg = layers.data("trg_ids", [max_len, 1], dtype="int64")
        lbl = layers.data("trg_labels", [max_len, 1], dtype="int64")
        pos = layers.data("pos_ids", [max_len], dtype="int64",
                          append_batch_size=False)
        causal = layers.assign(
            np.triu(np.full((max_len, max_len), -1e9, np.float32), k=1))
        loss, _logits = transformer(src, trg, lbl, pos, pos, src_vocab,
                                    trg_vocab, max_len, n_layer, n_head,
                                    d_model, d_inner, causal_mask=causal,
                                    attention_impl=attention_impl)
        opt.AdamOptimizer(learning_rate=lr).minimize(loss)
    return main, startup, {"loss": loss}


class LMProgram:
    """One program of the generation set: a (main, startup) pair plus
    feed names and the greedy next-token fetch name."""

    __slots__ = ("main", "startup", "feed_names", "fetch_name")

    def __init__(self, main, startup, feed_names, fetch_name):
        self.main = main
        self.startup = startup
        self.feed_names = list(feed_names)
        self.fetch_name = fetch_name


def kv_cache_names(n_layer):
    """The persistable cache var names of an n_layer decoder LM."""
    out = []
    for i in range(n_layer):
        out += [f"{KV_CACHE_PREFIX}l{i}.k", f"{KV_CACHE_PREFIX}l{i}.v"]
    return out


def _create_kv_caches(n_layer, slots, n_head, max_seq_len, d_key):
    """Create the [slots, h, max_seq, d_key] cache vars (persistable,
    zero-filled by startup)."""
    helper = LayerHelper("kv_cache")
    caches = []
    for i in range(n_layer):
        pair = []
        for kind in ("k", "v"):
            v = helper.create_global_variable(
                [slots, n_head, max_seq_len, d_key], "float32",
                name=f"{KV_CACHE_PREFIX}l{i}.{kind}", persistable=True)
            helper.set_variable_initializer(v, ConstantInitializer(0.0))
            pair.append(v)
        caches.append(tuple(pair))
    return caches


def _lm_embed(token_ids, positions, vocab_size, d_model, max_seq_len):
    """Word + positional embedding. token_ids: [b, t, 1] int64;
    positions: [t] (shared across rows) or [b] (decode: one position
    per slot, t == 1) int64."""
    word = layers.embedding(token_ids, size=[vocab_size, d_model])
    pe = layers.assign(_position_encoding_table(max_seq_len, d_model))
    pos = layers.gather(pe, positions)
    if word.shape[1] == 1 and len(pos.shape) == 2 \
            and pos.shape[0] == word.shape[0]:
        # decode: per-row positions -> [b, 1, d_model]
        pos = layers.unsqueeze(pos, [1])
    return layers.elementwise_add(word, pos, axis=-1)


def _lm_blocks(x, n_layer, d_model, n_head, d_inner, attn_fn):
    """Decoder blocks over embedded input [b, t, d_model]. attn_fn(i,
    qh, kh, vh) -> context heads [b, h, t, d_key]. The parameter-call
    SEQUENCE here (q/k/v/proj fc, post-attn LN, ffn pair, post-ffn LN,
    per layer) is the weight-sharing contract across modes."""
    d_key = d_model // n_head

    def split_heads(t):
        r = layers.reshape(t, [0, 0, n_head, d_key])
        return layers.transpose(r, [0, 2, 1, 3])

    for i in range(n_layer):
        q = layers.fc(x, size=d_model, num_flatten_dims=2,
                      bias_attr=False, name="tp_col_qkv")
        k = layers.fc(x, size=d_model, num_flatten_dims=2,
                      bias_attr=False, name="tp_col_qkv")
        v = layers.fc(x, size=d_model, num_flatten_dims=2,
                      bias_attr=False, name="tp_col_qkv")
        heads = attn_fn(i, split_heads(q), split_heads(k), split_heads(v))
        merged = layers.reshape(layers.transpose(heads, [0, 2, 1, 3]),
                                [0, 0, d_model])
        o = layers.fc(merged, size=d_model, num_flatten_dims=2,
                      bias_attr=False, name="tp_row_proj")
        x = _add_norm(x, o, d_model)
        x = _add_norm(x, ffn(x, d_model, d_inner), d_model)
    return x


def _sdpa_op(qh, kh, vh, mask, causal):
    helper = LayerHelper("mha")
    out = helper.create_tmp_variable(qh.dtype)
    inputs = {"Q": qh, "K": kh, "V": vh}
    if mask is not None:
        inputs["Mask"] = mask
    helper.append_op(type="scaled_dot_product_attention", inputs=inputs,
                     outputs={"Out": out}, attrs={"causal": causal})
    return out


def _cache_update(op_type, cache, new, index, index_slot):
    """Append a kv_cache_* op whose output IS its cache input: the
    executor classifies the cache read-write persistable state, and the
    op updates the scope's tensor in place."""
    helper = LayerHelper("kv_cache")
    helper.append_op(type=op_type,
                     inputs={"Cache": cache, "New": new,
                             index_slot: index},
                     outputs={"Out": cache}, attrs={})
    return cache


def _key_row_mask(valid, big=1e9):
    """bool [b, Sk] 'key row is live' -> additive [b, 1, 1, Sk]."""
    ok = layers.cast(valid, "float32")
    m = layers.scale(ok, scale=big, bias=-1.0, bias_after_scale=False)
    return layers.unsqueeze(m, [1, 2])


def _greedy_last_token(logits, lengths, seq_len):
    """logits [b, S, V], lengths [b] -> [b, 1] int64 argmax token at
    each row's last real position (one-hot select: no host round-trip
    per row)."""
    one = layers.fill_constant([1], "int64", 1)
    last = layers.elementwise_sub(layers.unsqueeze(lengths, [1]), one)
    oh = layers.one_hot(last, seq_len)                       # [b, S]
    sel = layers.elementwise_mul(logits, layers.unsqueeze(oh, [2]))
    rows = layers.reduce_sum(sel, dim=1)                     # [b, V]
    return layers.unsqueeze(layers.argmax(rows, axis=-1), [1])


def _build_lm_program(mode, seq_len, vocab_size, max_seq_len, slots,
                      n_layer, n_head, d_model, d_inner, seed):
    """Build one (main, startup) pair for `mode` at bucket `seq_len`
    (prompt bucket for full/prefill, cache-length bucket for decode)."""
    d_key = d_model // n_head
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = seed
    with framework.program_guard(main, startup), \
            framework.isolated_name_scope():
        if mode == "decode":
            ids = layers.data("token_ids", [slots, 1, 1], dtype="int64",
                              append_batch_size=False)
            positions = layers.data("positions", [slots], dtype="int64",
                                    append_batch_size=False)
            feeds = ["token_ids", "positions"]
        else:
            b = 1 if mode == "prefill" else slots
            ids = layers.data("token_ids", [b, seq_len, 1], dtype="int64",
                              append_batch_size=False)
            lengths = layers.data("lengths", [b], dtype="int64",
                                  append_batch_size=False)
            feeds = ["token_ids", "lengths"]
            if mode == "prefill":
                slot = layers.data("slot", [1], dtype="int64",
                                   append_batch_size=False)
                feeds.append("slot")
        caches = None
        if mode in ("prefill", "decode"):
            caches = _create_kv_caches(n_layer, slots, n_head,
                                       max_seq_len, d_key)

        if mode == "decode":
            # embed the single new token at each slot's own position
            x = _lm_embed(ids, positions, vocab_size, d_model, max_seq_len)
            ar = layers.unsqueeze(layers.range(0, seq_len, 1, "int64"),
                                  [0])                       # [1, L]
            pos2 = layers.unsqueeze(positions, [1])          # [slots, 1]
            mask = _key_row_mask(layers.less_equal(ar, pos2))

            def attn(i, qh, kh, vh):
                kc, vc = caches[i]
                _cache_update("kv_cache_append", kc, kh, positions, "Pos")
                _cache_update("kv_cache_append", vc, vh, positions, "Pos")
                k_l = layers.slice(kc, axes=[2], starts=[0],
                                   ends=[seq_len])
                v_l = layers.slice(vc, axes=[2], starts=[0],
                                   ends=[seq_len])
                return _sdpa_op(qh, k_l, v_l, mask, causal=False)
        else:
            pos_ids = layers.assign(
                np.arange(seq_len).astype(np.int64))
            x = _lm_embed(ids, pos_ids, vocab_size, d_model, max_seq_len)
            ar = layers.unsqueeze(layers.range(0, seq_len, 1, "int64"),
                                  [0])                       # [1, S]
            len2 = layers.unsqueeze(lengths, [1])            # [b, 1]
            pad_mask = _key_row_mask(layers.less_than(ar, len2))

            def attn(i, qh, kh, vh):
                if mode == "prefill":
                    kc, vc = caches[i]
                    _cache_update("kv_cache_write", kc, kh, slot, "Slot")
                    _cache_update("kv_cache_write", vc, vh, slot, "Slot")
                return _sdpa_op(qh, kh, vh, pad_mask, causal=True)

        x = _lm_blocks(x, n_layer, d_model, n_head, d_inner, attn)
        logits = layers.fc(x, size=vocab_size, num_flatten_dims=2,
                           name="lm_head")
        if mode == "decode":
            next_tok = layers.argmax(logits, axis=-1)        # [slots, 1]
        else:
            next_tok = _greedy_last_token(logits, lengths, seq_len)
    return LMProgram(main, startup, feeds, next_tok.name)


def build_decoder_lm(vocab_size=1000, max_seq_len=64, slots=4,
                     prompt_buckets=(16, 32, 64),
                     cache_buckets=(16, 32, 64), n_layer=2, n_head=4,
                     d_model=64, d_inner=128, seed=0):
    """Build the full generation program set. Returns a dict:

      {"prefill": {S: LMProgram}, "decode": {L: LMProgram},
       "full": {S: LMProgram}, "startup": Program,
       "cache_names": [...], "spec": {...}}

    Every LMProgram creates the same parameters under the same names,
    so running ANY single startup initializes weights (and caches) for
    all of them; "startup" is the canonical one. "full" programs carry
    no cache ops."""
    prompt_buckets = sorted(set(int(s) for s in prompt_buckets))
    cache_buckets = sorted(set(int(c) for c in cache_buckets))
    if prompt_buckets[-1] > max_seq_len or cache_buckets[-1] > max_seq_len:
        raise ValueError(
            f"bucket exceeds max_seq_len={max_seq_len}: prompt "
            f"{prompt_buckets}, cache {cache_buckets}")
    if d_model % n_head:
        raise ValueError(f"d_model={d_model} not divisible by "
                         f"n_head={n_head}")
    args = (vocab_size, max_seq_len, slots, n_layer, n_head, d_model,
            d_inner, seed)
    out = {"prefill": {}, "decode": {}, "full": {}}
    for s in prompt_buckets:
        out["prefill"][s] = _build_lm_program("prefill", s, *args)
        out["full"][s] = _build_lm_program("full", s, *args)
    for c in cache_buckets:
        out["decode"][c] = _build_lm_program("decode", c, *args)
    out["startup"] = out["prefill"][prompt_buckets[0]].startup
    out["cache_names"] = kv_cache_names(n_layer)
    out["spec"] = {
        "vocab_size": vocab_size, "max_seq_len": max_seq_len,
        "slots": slots, "prompt_buckets": list(prompt_buckets),
        "cache_buckets": list(cache_buckets), "n_layer": n_layer,
        "n_head": n_head, "d_model": d_model, "d_inner": d_inner,
        "seed": seed,
        "kv_cache_layout": "[slots, n_head, max_seq_len, d_key]",
    }
    return out
