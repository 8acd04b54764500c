"""Model code of the port: the GPT language model (its training program
and its serving math), ResNet, the two recurrent configurations of the
reference's benchmark sweep (the stacked-LSTM text classifier and the
seq2seq attention NMT), its image rows (SmallNet, AlexNet, GoogLeNet,
VGG) and DeepSpeech2 with CTC, the MNIST LeNet, the CRF tagger
(``label_semantic_roles``), and the book's small models: ``fit_a_line``,
``word2vec``, ``recommender`` and ``ctr_dnn``."""

from . import alexnet  # noqa: F401
from . import ctr_dnn  # noqa: F401
from . import deep_speech2  # noqa: F401
from . import fit_a_line  # noqa: F401
from . import googlenet  # noqa: F401
from . import label_semantic_roles  # noqa: F401
from . import lenet  # noqa: F401
from . import recommender  # noqa: F401
from . import resnet  # noqa: F401
from . import seq2seq  # noqa: F401
from . import smallnet  # noqa: F401
from . import text_classification  # noqa: F401
from . import transformer  # noqa: F401
from . import vgg  # noqa: F401
from . import word2vec  # noqa: F401
