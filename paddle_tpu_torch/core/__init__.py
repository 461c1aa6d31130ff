from .ir import Program, BlockDesc, OpDesc, VarDesc  # noqa: F401
from .scope import Scope, global_scope  # noqa: F401
from .registry import OpRegistry, register_op  # noqa: F401
