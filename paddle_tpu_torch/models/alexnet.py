"""AlexNet (reference: benchmark/README.md:31-38; config
benchmark/paddle/image/alexnet.py).

The port's copy of ``paddle_tpu/models/alexnet.py``: Caffe-style widths
96/256/384/384/256, an lrn after conv1 and conv2 (``with_lrn``), no
groups on conv2/4/5, the same ops, attrs and var names. The convs run
through the conv2d op (cuDNN on the card); no op dispatches a hand
kernel. Its dropout draws torch's bits, not JAX's, and keeps the
compiled step from a CUDA graph."""
from __future__ import annotations

from .. import framework, layers, optimizer as opt


def alexnet(input, class_dim=1000, with_lrn=True):
    conv1 = layers.conv2d(input, num_filters=96, filter_size=11,
                          stride=4, padding=2, act="relu")
    if with_lrn:
        conv1 = layers.lrn(conv1, n=5, alpha=1e-4, beta=0.75)
    pool1 = layers.pool2d(conv1, pool_size=3, pool_stride=2,
                          pool_type="max")
    conv2 = layers.conv2d(pool1, num_filters=256, filter_size=5,
                          padding=2, act="relu")
    if with_lrn:
        conv2 = layers.lrn(conv2, n=5, alpha=1e-4, beta=0.75)
    pool2 = layers.pool2d(conv2, pool_size=3, pool_stride=2,
                          pool_type="max")
    conv3 = layers.conv2d(pool2, num_filters=384, filter_size=3,
                          padding=1, act="relu")
    conv4 = layers.conv2d(conv3, num_filters=384, filter_size=3,
                          padding=1, act="relu")
    conv5 = layers.conv2d(conv4, num_filters=256, filter_size=3,
                          padding=1, act="relu")
    pool5 = layers.pool2d(conv5, pool_size=3, pool_stride=2,
                          pool_type="max")
    drop6 = layers.dropout(pool5, 0.5)
    fc6 = layers.fc(drop6, size=4096, act="relu")
    drop7 = layers.dropout(fc6, 0.5)
    fc7 = layers.fc(drop7, size=4096, act="relu")
    return layers.fc(fc7, size=class_dim, act="softmax")


def build_train(class_dim=1000, image_shape=(3, 224, 224), lr=0.01):
    """Build (main, startup, fetches) for one training step: feeds img
    float32 [b, *image_shape] and label int64 [b, 1]; Momentum 0.9."""
    main, startup = framework.Program(), framework.Program()
    with framework.program_guard(main, startup):
        img = layers.data("img", list(image_shape), dtype="float32")
        label = layers.data("label", [1], dtype="int64")
        pred = alexnet(img, class_dim)
        loss = layers.mean(layers.cross_entropy(input=pred, label=label))
        acc = layers.accuracy(input=pred, label=label)
        opt.MomentumOptimizer(learning_rate=lr, momentum=0.9).minimize(
            loss)
    return main, startup, {"loss": loss, "acc": acc, "pred": pred}
