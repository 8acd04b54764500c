"""The layers DSL (``paddle_tpu/layers``): each layer function creates
parameters through LayerHelper and appends ops to the current program.
Ported so far: what ``models.transformer``, ``resnet``, the image zoo,
``text_classification``, ``seq2seq``, ``deep_speech2`` and
``label_semantic_roles`` reach, and ``StaticRNN``."""

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
