"""The port's model zoo (the JAX package's models/, model for model):
MNIST conv, ResNet-50 with SE-ResNeXt, VGG-16, AlexNet, GoogLeNet, the
stacked-LSTM language model, the Transformer NMT and decoder LM, DeepFM.
``ssd`` waits for the detection ops (ROADMAP A11)."""
from . import alexnet  # noqa: F401
from . import deepfm  # noqa: F401
from . import googlenet  # noqa: F401
from . import lstm_lm  # noqa: F401
from . import mnist  # noqa: F401
from . import resnet  # noqa: F401
from . import transformer  # noqa: F401
from . import vgg  # noqa: F401
