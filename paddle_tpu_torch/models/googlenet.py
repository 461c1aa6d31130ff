"""GoogLeNet / Inception-v1 (reference: benchmark/README.md:45-51;
v2-era config in benchmark/paddle/image/googlenet.py).

The port's copy of ``paddle_tpu/models/googlenet.py``: nine inception
modules, the two auxiliary classifier heads at train time (weighted 0.3)
or none (``with_aux=False``, the benchmark protocol), the same ops,
attrs and var names. Every conv2d runs through the conv2d op (cuDNN on
the card); no op dispatches a hand kernel. Its dropout draws torch's
bits, not JAX's, and keeps the compiled step from a CUDA graph (dropout
is registered capturable=False)."""
from __future__ import annotations

from .. import framework, layers, optimizer as opt


def _inception(x, c1, c3r, c3, c5r, c5, proj):
    b1 = layers.conv2d(x, num_filters=c1, filter_size=1, act="relu")
    b3 = layers.conv2d(x, num_filters=c3r, filter_size=1, act="relu")
    b3 = layers.conv2d(b3, num_filters=c3, filter_size=3, padding=1,
                       act="relu")
    b5 = layers.conv2d(x, num_filters=c5r, filter_size=1, act="relu")
    b5 = layers.conv2d(b5, num_filters=c5, filter_size=5, padding=2,
                       act="relu")
    bp = layers.pool2d(x, pool_size=3, pool_stride=1, pool_padding=1,
                       pool_type="max")
    bp = layers.conv2d(bp, num_filters=proj, filter_size=1, act="relu")
    return layers.concat([b1, b3, b5, bp], axis=1)


def _aux_head(x, class_dim):
    p = layers.pool2d(x, pool_size=5, pool_stride=3, pool_type="avg")
    c = layers.conv2d(p, num_filters=128, filter_size=1, act="relu")
    f = layers.fc(c, size=1024, act="relu")
    d = layers.dropout(f, 0.7)
    return layers.fc(d, size=class_dim, act="softmax")


def googlenet(input, class_dim=1000, with_aux=True):
    """Returns (main_softmax, aux1_softmax, aux2_softmax); the aux heads
    are None when with_aux=False."""
    x = layers.conv2d(input, num_filters=64, filter_size=7, stride=2,
                      padding=3, act="relu")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_type="max")
    x = layers.conv2d(x, num_filters=64, filter_size=1, act="relu")
    x = layers.conv2d(x, num_filters=192, filter_size=3, padding=1,
                      act="relu")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_type="max")
    x = _inception(x, 64, 96, 128, 16, 32, 32)     # 3a
    x = _inception(x, 128, 128, 192, 32, 96, 64)   # 3b
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_type="max")
    x = _inception(x, 192, 96, 208, 16, 48, 64)    # 4a
    aux1 = _aux_head(x, class_dim) if with_aux else None
    x = _inception(x, 160, 112, 224, 24, 64, 64)   # 4b
    x = _inception(x, 128, 128, 256, 24, 64, 64)   # 4c
    x = _inception(x, 112, 144, 288, 32, 64, 64)   # 4d
    aux2 = _aux_head(x, class_dim) if with_aux else None
    x = _inception(x, 256, 160, 320, 32, 128, 128)  # 4e
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_type="max")
    x = _inception(x, 256, 160, 320, 32, 128, 128)  # 5a
    x = _inception(x, 384, 192, 384, 48, 128, 128)  # 5b
    x = layers.pool2d(x, pool_type="avg", global_pooling=True)
    x = layers.dropout(x, 0.4)
    main = layers.fc(x, size=class_dim, act="softmax")
    return main, aux1, aux2


def build_train(class_dim=1000, image_shape=(3, 224, 224), lr=0.01,
                with_aux=True):
    """Build (main, startup, fetches) for one training step: feeds img
    float32 [b, *image_shape] and label int64 [b, 1]; Momentum 0.9."""
    main_p, startup = framework.Program(), framework.Program()
    with framework.program_guard(main_p, startup):
        img = layers.data("img", list(image_shape), dtype="float32")
        label = layers.data("label", [1], dtype="int64")
        pred, aux1, aux2 = googlenet(img, class_dim, with_aux=with_aux)
        loss = layers.mean(layers.cross_entropy(input=pred,
                                                label=label))
        if with_aux:
            loss_a1 = layers.mean(layers.cross_entropy(input=aux1,
                                                       label=label))
            loss_a2 = layers.mean(layers.cross_entropy(input=aux2,
                                                       label=label))
            loss = loss + 0.3 * loss_a1 + 0.3 * loss_a2
        acc = layers.accuracy(input=pred, label=label)
        opt.MomentumOptimizer(learning_rate=lr, momentum=0.9).minimize(
            loss)
    return main_p, startup, {"loss": loss, "acc": acc, "pred": pred}
