"""The layers DSL (``paddle_tpu/layers``): each layer function creates
parameters through LayerHelper and appends ops to the current program.
Ported so far: what ``models.transformer``, ``resnet``, the image zoo,
``text_classification``, ``seq2seq`` (its decode too),
``deep_speech2``, ``label_semantic_roles``, ``fit_a_line``,
``word2vec``, ``recommender``, ``ctr_dnn`` and ``ssd`` reach,
``StaticRNN``, ``While``, the tensor arrays, the detection layers and
the rest of the reference's tensor and activation wrappers."""

from .io import data, sparse_data
from .tensor import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403
from . import io
from . import tensor
from . import nn
from . import ops
from . import control_flow
from . import detection
