"""Op lowerings: plain functions on torch tensors, registered under the
JAX package's op names and slots (``paddle_tpu/ops/``).  Importing this
package registers every ported op."""

from . import math_ops  # noqa: F401
from . import tensor_ops  # noqa: F401
from . import nn_ops  # noqa: F401
from . import activation_ops  # noqa: F401
from . import loss_ops  # noqa: F401
from . import random_ops  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import control_flow_ops  # noqa: F401
from . import attention_ops  # noqa: F401
from . import metric_ops  # noqa: F401
from . import sequence_ops  # noqa: F401
from . import rnn_ops  # noqa: F401
from . import ctc_ops  # noqa: F401
from . import crf_ops  # noqa: F401
from . import beam_search_ops  # noqa: F401
from . import beam_ce_ops  # noqa: F401
from . import detection_ops  # noqa: F401
