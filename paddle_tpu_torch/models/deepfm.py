"""DeepFM CTR model (BASELINE config 5: the wide-sparse workload).

The port's copy of ``deepfm`` and ``build_train`` from
``paddle_tpu/models/deepfm.py``: the same ops, attrs and var names. Both
embedding tables live whole on one device and are gathered densely;
their gradients are dense tables too. The row-sharded tables
(``distributed=True``) and ``DeepFMSharded`` wait for ROADMAP A10.
"""
from __future__ import annotations

from .. import framework, layers, optimizer as opt


def deepfm(feat_ids, feat_vals, label, num_features=int(1e5), embed_dim=8,
           layer_sizes=(400, 400, 400), distributed=False):
    """feat_ids: [b, f, 1] int64; feat_vals: [b, f]; label [b, 1].
    Returns (pred, loss)."""
    if distributed:
        raise NotImplementedError(
            "deepfm(distributed=True): row-sharded embedding tables are "
            "not ported yet (ROADMAP A10)")
    num_fields = int(feat_ids.shape[1])

    # ---- first order: w_i * x_i
    w1 = layers.embedding(feat_ids, size=[num_features, 1],
                          is_distributed=distributed)  # [b, f, 1]
    first = layers.reduce_sum(
        layers.elementwise_mul(layers.reshape(w1, [0, num_fields]),
                               feat_vals), dim=1, keep_dim=True)

    # ---- second order (FM): 0.5 * ((sum v x)^2 - sum (v x)^2)
    emb = layers.embedding(feat_ids, size=[num_features, embed_dim],
                           is_distributed=distributed)
    vals = layers.reshape(feat_vals, [0, num_fields, 1])
    vx = layers.elementwise_mul(emb, vals)          # [b, f, k]
    sum_vx = layers.reduce_sum(vx, dim=1)           # [b, k]
    sum_vx_sq = layers.square(sum_vx)
    sq_vx_sum = layers.reduce_sum(layers.square(vx), dim=1)
    second = layers.scale(
        layers.reduce_sum(layers.elementwise_sub(sum_vx_sq, sq_vx_sum),
                          dim=1, keep_dim=True), scale=0.5)

    # ---- deep part
    deep = layers.reshape(vx, [0, num_fields * embed_dim])
    for size in layer_sizes:
        deep = layers.fc(deep, size=size, act="relu")
    deep_out = layers.fc(deep, size=1)

    logit = layers.elementwise_add(
        layers.elementwise_add(first, second), deep_out)
    pred = layers.sigmoid(logit)
    loss = layers.mean(
        layers.sigmoid_cross_entropy_with_logits(logit, label))
    return pred, loss


def build_train(num_features=int(1e5), num_fields=39, embed_dim=8, lr=1e-3,
                distributed=False):
    """The DeepFM train step: (main, startup, {"loss", "pred"}). Feeds:
    feat_ids int64 [b, fields, 1], feat_vals float32 [b, fields], label
    float32 [b, 1]; the optimizer is Adam."""
    main, startup = framework.Program(), framework.Program()
    with framework.program_guard(main, startup):
        feat_ids = layers.data("feat_ids", [num_fields, 1], dtype="int64")
        feat_vals = layers.data("feat_vals", [num_fields],
                                dtype="float32")
        label = layers.data("label", [1], dtype="float32")
        pred, loss = deepfm(feat_ids, feat_vals, label, num_features,
                            embed_dim, distributed=distributed)
        opt.AdamOptimizer(learning_rate=lr).minimize(loss)
    return main, startup, {"loss": loss, "pred": pred}
