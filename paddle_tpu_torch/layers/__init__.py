from .tensor import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .io import data  # noqa: F401
from .ops import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403
from . import math_op_patch

math_op_patch.monkey_patch_variable()
