"""Host-side composable metrics (``paddle_tpu/metrics.py``; the v2
``event_handler`` statistics helpers).  They accumulate on the host from
fetched values; the in-program accumulating evaluators live in
``paddle_tpu_torch.evaluator``."""

import numpy as np
import torch


def _host(value):
    """A fetched value as numpy: a tensor (``return_numpy=False``, maybe on
    the card) is copied to the host."""
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()
    return np.asarray(value)


class MetricBase:
    def __init__(self, name):
        self._name = name

    def reset(self):
        raise NotImplementedError

    def update(self, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Accuracy(MetricBase):
    def __init__(self, name="accuracy"):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight=1.0):
        self.value += float(_host(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        return self.value / max(self.weight, 1e-12)


class EditDistance(MetricBase):
    def __init__(self, name="edit_distance"):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.total_distance = 0.0
        self.seq_num = 0

    def update(self, distances, seq_num):
        self.total_distance += float(np.sum(_host(distances)))
        self.seq_num += int(seq_num)

    def eval(self):
        return self.total_distance / max(self.seq_num, 1)


class CompositeMetric(MetricBase):
    def __init__(self, name="composite"):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def update(self, **kwargs):
        for m in self._metrics:
            m.update(**kwargs)

    def eval(self):
        return [m.eval() for m in self._metrics]
