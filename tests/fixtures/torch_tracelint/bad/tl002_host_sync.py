"""Host syncs on tensors in captured code (the lr-on-the-device class):
``float()`` and ``.item()`` inside functions a CUDA graph captures, and
``float()`` directly on a graphed callable's output on the host.
tracelint must flag each (TL002)."""
import torch


def scaled_update(params, grads, lr):
    scale = float(lr)                       # device→host sync in capture
    return [p - scale * g for p, g in zip(params, grads)]


def loss_scalar(logits, targets):
    loss = torch.mean((logits - targets) ** 2)
    return loss.item()                      # fails under capture outright


class CapturedRound:
    def __init__(self, params, grads, lr, logits, targets):
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.new = scaled_update(params, grads, lr)
            self.loss = loss_scalar(logits, targets)


def _project(p, x):
    return x @ p


_forward = torch.cuda.make_graphed_callables(
    _project, (torch.ones(4, 4), torch.ones(4, 4)))


def host_metric(p, x):
    return float(_forward(p, x))            # blocks dispatch per call
