"""MNIST conv net and MLP (reference: python/paddle/fluid/tests/book/
test_recognize_digits.py conv variant + benchmark/fluid/mnist.py).

The port's copy of ``paddle_tpu/models/mnist.py``: the same ops, attrs
and var names."""
from __future__ import annotations

from .. import framework, layers, nets, optimizer as opt


def conv_net(img, label):
    conv_pool_1 = nets.simple_img_conv_pool(
        input=img, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act="relu")
    conv_pool_2 = nets.simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act="relu")
    prediction = layers.fc(conv_pool_2, size=10, act="softmax")
    loss = layers.cross_entropy(input=prediction, label=label)
    avg_loss = layers.mean(loss)
    acc = layers.accuracy(input=prediction, label=label)
    return prediction, avg_loss, acc


def mlp(img, label):
    hidden = layers.fc(img, size=200, act="tanh")
    hidden = layers.fc(hidden, size=200, act="tanh")
    prediction = layers.fc(hidden, size=10, act="softmax")
    loss = layers.mean(layers.cross_entropy(input=prediction, label=label))
    acc = layers.accuracy(input=prediction, label=label)
    return prediction, loss, acc


def build_train(program_ctx=None, lr=0.001, net="conv"):
    """Build (main, startup, fetches) for one training step. Feeds: img
    float32 [b, 1, 28, 28] and label int64 [b, 1]; Adam."""
    main, startup = framework.Program(), framework.Program()
    with framework.program_guard(main, startup):
        img = layers.data("img", [1, 28, 28], dtype="float32")
        label = layers.data("label", [1], dtype="int64")
        fn = conv_net if net == "conv" else mlp
        pred, loss, acc = fn(img, label)
        opt.AdamOptimizer(learning_rate=lr).minimize(loss)
    return main, startup, {"loss": loss, "acc": acc, "pred": pred}
