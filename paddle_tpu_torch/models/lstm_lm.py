"""Stacked-LSTM language model (reference: benchmark/fluid/
stacked_dynamic_lstm.py + book understand_sentiment stacked LSTM).

The port's copy of ``paddle_tpu/models/lstm_lm.py`` (``stacked_lstm_net``,
``language_model``, ``build_train``): the same ops, attrs and var names.
Variable-length sequences ride the ragged (padded + lengths)
representation; each ``lstm`` op runs the fused-LSTM kernels on the
card (ops/sequence_ops.py).
"""
from __future__ import annotations

from .. import framework, layers, optimizer as opt


def stacked_lstm_net(data, vocab_size, hid_dim=512, emb_dim=512,
                     stacked_num=3, class_dim=2):
    """Sentiment-style classifier over ragged word ids."""
    emb = layers.embedding(data, size=[vocab_size, emb_dim])
    fc1 = layers.fc(emb, size=hid_dim * 4)
    lstm1, _cell = layers.dynamic_lstm(fc1, size=hid_dim * 4)
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = layers.fc(inputs, size=hid_dim * 4)
        lstm, _cell = layers.dynamic_lstm(fc, size=hid_dim * 4,
                                          is_reverse=(i % 2) == 0)
        inputs = [fc, lstm]
    fc_last = layers.sequence_pool(inputs[0], pool_type="max")
    lstm_last = layers.sequence_pool(inputs[1], pool_type="max")
    prediction = layers.fc([fc_last, lstm_last], size=class_dim,
                           act="softmax")
    return prediction


def language_model(words, targets, vocab_size, emb_dim=256, hid_dim=512,
                   num_layers=2):
    """Next-token LM over ragged word ids (PTB-style)."""
    emb = layers.embedding(words, size=[vocab_size, emb_dim])
    x = emb
    for i in range(num_layers):
        proj = layers.fc(x, size=hid_dim * 4)
        x, _ = layers.dynamic_lstm(proj, size=hid_dim * 4)
    logits = layers.fc(x, size=vocab_size)
    loss = layers.softmax_with_cross_entropy(logits, targets)
    avg = layers.mean(layers.sequence_pool(loss, pool_type="sum"))
    return avg, logits


def build_train(vocab_size=10000, emb_dim=256, hid_dim=512, num_layers=2,
                lr=1.0):
    """The LM train step: (main, startup, {"loss": loss}). Feeds: words
    and targets, int64 ids [b, t, 1] as LoDTensors or RaggedPairs (one
    LoD level); the optimizer is SGD."""
    main, startup = framework.Program(), framework.Program()
    with framework.program_guard(main, startup):
        words = layers.data("words", [1], dtype="int64", lod_level=1)
        targets = layers.data("targets", [1], dtype="int64", lod_level=1)
        loss, logits = language_model(words, targets, vocab_size, emb_dim,
                                      hid_dim, num_layers)
        opt.SGDOptimizer(learning_rate=lr).minimize(loss)
    return main, startup, {"loss": loss}
