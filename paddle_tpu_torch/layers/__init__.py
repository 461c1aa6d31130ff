from .tensor import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .io import data  # noqa: F401
from .ops import *  # noqa: F401,F403
