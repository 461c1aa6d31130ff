"""Op compute rules: importing this package registers every ported op."""
from . import core_ops  # noqa: F401
from . import math_ops  # noqa: F401
from . import tensor_ops  # noqa: F401
from . import nn_ops  # noqa: F401
from . import sequence_ops  # noqa: F401
from . import crf_ops  # noqa: F401
from . import cache_ops  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import metric_ops  # noqa: F401
from . import control_flow_ops  # noqa: F401
from . import fusion_ops  # noqa: F401
