"""ResNet (reference: benchmark/fluid/resnet.py model family).

The port's copy of ``paddle_tpu/models/resnet.py`` (basic and bottleneck
blocks, ImageNet depths 18-152, ``resnet_cifar10``, ``build_train``, and
the SE-ResNeXt builders ``squeeze_excitation``, ``se_resnext_block``,
``se_resnext``, ``build_se_resnext_train``): the same ops, attrs and var
names. Every conv2d, the SE-ResNeXt's grouped 3x3 among them, runs
through the conv2d op (cuDNN on the card), as the reference's runs
through XLA; neither dispatches the fused conv + BN kernels. The rewrite
pipeline's SEBlockOutlining turns each SE gate of a forward-only program
(a for_test clone) into one se_block op; in a training program the
backward reads the gate's intermediates, so no gate is outlined, as in
the reference. SE-ResNeXt's dropout draws torch's bits, not JAX's."""
from __future__ import annotations

from .. import framework, layers, optimizer as opt


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None):
    conv = layers.conv2d(input=input, num_filters=num_filters,
                         filter_size=filter_size, stride=stride,
                         padding=(filter_size - 1) // 2, groups=groups,
                         act=None, bias_attr=False)
    return layers.batch_norm(input=conv, act=act)


def shortcut(input, ch_out, stride):
    ch_in = int(input.shape[1])
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride)
    return input


def bottleneck_block(input, num_filters, stride=1):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu")
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride, act="relu")
    conv2 = conv_bn_layer(conv1, num_filters * 4, 1, act=None)
    short = shortcut(input, num_filters * 4, stride)
    return layers.elementwise_add(short, conv2, act="relu")


def basic_block(input, num_filters, stride=1):
    conv0 = conv_bn_layer(input, num_filters, 3, stride=stride, act="relu")
    conv1 = conv_bn_layer(conv0, num_filters, 3, act=None)
    short = shortcut(input, num_filters, stride)
    return layers.elementwise_add(short, conv1, act="relu")


_DEPTH = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def resnet(img, class_dim=1000, depth=50):
    block_kind, counts = _DEPTH[depth]
    block_fn = bottleneck_block if block_kind == "bottleneck" \
        else basic_block
    conv = conv_bn_layer(img, 64, 7, stride=2, act="relu")
    pool = layers.pool2d(conv, pool_size=3, pool_type="max", pool_stride=2,
                         pool_padding=1)
    num_filters = [64, 128, 256, 512]
    for stage, count in enumerate(counts):
        for i in range(count):
            stride = 2 if i == 0 and stage > 0 else 1
            pool = block_fn(pool, num_filters[stage], stride)
    pool = layers.pool2d(pool, pool_type="avg", global_pooling=True)
    out = layers.fc(pool, size=class_dim, act="softmax")
    return out


def squeeze_excitation(input, num_channels, reduction_ratio=16):
    """SE block: global-pool -> bottleneck MLP -> channel gates."""
    pool = layers.pool2d(input, pool_type="avg", global_pooling=True)
    squeeze = layers.fc(pool, size=max(1, num_channels // reduction_ratio),
                        act="relu")
    excitation = layers.fc(squeeze, size=num_channels, act="sigmoid")
    gates = layers.reshape(excitation, [-1, num_channels, 1, 1])
    return layers.elementwise_mul(input, gates, axis=0)


def se_resnext_block(input, num_filters, stride=1, cardinality=32,
                     reduction_ratio=16):
    """SE-ResNeXt bottleneck: grouped 3x3 (cardinality) + SE gating."""
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu")
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride,
                          groups=cardinality, act="relu")
    conv2 = conv_bn_layer(conv1, num_filters * 2, 1, act=None)
    scaled = squeeze_excitation(conv2, num_filters * 2, reduction_ratio)
    short = shortcut(input, num_filters * 2, stride)
    return layers.elementwise_add(short, scaled, act="relu")


def se_resnext(img, class_dim=1000, layers_counts=(3, 4, 6, 3),
               cardinality=32, reduction_ratio=16):
    """SE-ResNeXt-50-style network (counts (3, 8, 36, 3) give the 152
    variant that bench.py measures at batch 12)."""
    conv = conv_bn_layer(img, 64, 7, stride=2, act="relu")
    pool = layers.pool2d(conv, pool_size=3, pool_type="max",
                         pool_stride=2, pool_padding=1)
    num_filters = [128, 256, 512, 1024]
    for stage, count in enumerate(layers_counts):
        for i in range(count):
            stride = 2 if i == 0 and stage > 0 else 1
            pool = se_resnext_block(pool, num_filters[stage], stride,
                                    cardinality, reduction_ratio)
    pool = layers.pool2d(pool, pool_type="avg", global_pooling=True)
    drop = layers.dropout(pool, dropout_prob=0.2)
    return layers.fc(drop, size=class_dim, act="softmax")


def build_se_resnext_train(class_dim=1000, image_shape=(3, 224, 224),
                           layers_counts=(3, 4, 6, 3), cardinality=32,
                           lr=0.1):
    """Build (main, startup, fetches) for one SE-ResNeXt training step:
    feeds img float32 [b, *image_shape] and label int64 [b, 1];
    Momentum 0.9."""
    main, startup = framework.Program(), framework.Program()
    with framework.program_guard(main, startup):
        img = layers.data("img", list(image_shape), dtype="float32")
        label = layers.data("label", [1], dtype="int64")
        pred = se_resnext(img, class_dim, layers_counts, cardinality)
        loss = layers.mean(layers.cross_entropy(input=pred, label=label))
        acc = layers.accuracy(input=pred, label=label)
        opt.MomentumOptimizer(learning_rate=lr, momentum=0.9).minimize(
            loss)
    return main, startup, {"loss": loss, "acc": acc, "pred": pred}


def resnet_cifar10(img, class_dim=10, depth=32):
    n = (depth - 2) // 6
    conv = conv_bn_layer(img, 16, 3, act="relu")
    for stage, nf in enumerate([16, 32, 64]):
        for i in range(n):
            stride = 2 if i == 0 and stage > 0 else 1
            conv = basic_block(conv, nf, stride)
    pool = layers.pool2d(conv, pool_type="avg", global_pooling=True)
    return layers.fc(pool, size=class_dim, act="softmax")


def build_train(class_dim=1000, depth=50, image_shape=(3, 224, 224),
                lr=0.1, optimizer="momentum"):
    """Build (main, startup, fetches) for one training step. Feeds: img
    float32 [b, *image_shape] and label int64 [b, 1]; Momentum 0.9 (or
    SGD)."""
    main, startup = framework.Program(), framework.Program()
    with framework.program_guard(main, startup):
        img = layers.data("img", list(image_shape), dtype="float32")
        label = layers.data("label", [1], dtype="int64")
        pred = resnet(img, class_dim, depth)
        loss = layers.mean(layers.cross_entropy(input=pred, label=label))
        acc = layers.accuracy(input=pred, label=label)
        if optimizer == "momentum":
            opt.MomentumOptimizer(learning_rate=lr, momentum=0.9).minimize(
                loss)
        else:
            opt.SGDOptimizer(learning_rate=lr).minimize(loss)
    return main, startup, {"loss": loss, "acc": acc, "pred": pred}
