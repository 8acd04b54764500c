"""The layers DSL (``paddle_tpu/layers``): each layer function creates
parameters through LayerHelper and appends ops to the current program.
Ported so far: what ``models.transformer``, ``resnet``,
``text_classification`` and ``seq2seq`` reach, and ``StaticRNN``."""

from .io import data
from .tensor import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from . import io
from . import tensor
from . import nn
from . import ops
from . import control_flow
