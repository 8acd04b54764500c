"""The layers DSL (``paddle_tpu/layers``): each layer function creates
parameters through LayerHelper and appends ops to the current program.
Ported so far: what ``models.transformer``, ``resnet``, the image zoo,
``text_classification``, ``seq2seq`` (its decode too),
``deep_speech2``, ``label_semantic_roles``, ``fit_a_line``,
``word2vec``, ``recommender`` and ``ctr_dnn`` reach, ``StaticRNN``,
``While`` and the tensor arrays."""

from .io import data, sparse_data
from .tensor import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from . import io
from . import tensor
from . import nn
from . import ops
from . import control_flow
