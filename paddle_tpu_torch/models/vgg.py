"""VGG-16 (reference: benchmark/fluid/vgg.py + benchmark/cluster/vgg16).

The port's copy of ``paddle_tpu/models/vgg.py``: the same ops, attrs and
var names. Its dropout draws torch's bits, not JAX's."""
from __future__ import annotations

from .. import framework, layers, nets, optimizer as opt


def vgg16(input, class_dim=1000, with_bn=True):
    def conv_block(inp, num_filter, groups):
        return nets.img_conv_group(
            input=inp, conv_num_filter=[num_filter] * groups,
            pool_size=2, pool_stride=2, conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=with_bn)

    conv1 = conv_block(input, 64, 2)
    conv2 = conv_block(conv1, 128, 2)
    conv3 = conv_block(conv2, 256, 3)
    conv4 = conv_block(conv3, 512, 3)
    conv5 = conv_block(conv4, 512, 3)
    drop = layers.dropout(conv5, 0.5)
    fc1 = layers.fc(drop, size=4096, act=None)
    bn = layers.batch_norm(fc1, act="relu") if with_bn else \
        layers.relu(fc1)
    drop2 = layers.dropout(bn, 0.5)
    fc2 = layers.fc(drop2, size=4096, act=None)
    return layers.fc(fc2, size=class_dim, act="softmax")


def build_train(class_dim=10, image_shape=(3, 32, 32), lr=0.01):
    main, startup = framework.Program(), framework.Program()
    with framework.program_guard(main, startup):
        img = layers.data("img", list(image_shape), dtype="float32")
        label = layers.data("label", [1], dtype="int64")
        pred = vgg16(img, class_dim)
        loss = layers.mean(layers.cross_entropy(input=pred, label=label))
        acc = layers.accuracy(input=pred, label=label)
        opt.AdamOptimizer(learning_rate=lr).minimize(loss)
    return main, startup, {"loss": loss, "acc": acc, "pred": pred}
