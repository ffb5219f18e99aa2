"""The CNN encoder's count (``models/actor_critic.CNNEncoder``): its
convolutions' multiply-adds (``counts/work.cnn_macs``) at the bf16 peak,
the bf16 images read once.

An encoder's count file gives ``forward_flops``, ``train_flops`` (a call
with gradients on) and ``nbytes`` of ``images`` images of ``w`` x ``h``,
and the ``PEAK`` its operations run at; ``drivers/train.Work`` finds it
by the encoder's name."""
from portbench.counts import work

PEAK = work.PEAK_BF16


def forward_flops(w: int, h: int, images: int) -> float:
    return work.cnn_forward_flops(w, h, images)


def train_flops(w: int, h: int, images: int) -> float:
    return work.cnn_train_flops(w, h, images)


def nbytes(w: int, h: int, images: int) -> float:
    return 2.0 * images * w * h
