"""The paper's own model: an MLP over 2917 binary medication features.

The paper (§2.2) describes an L-layer DNN taking 2917 binary inputs and
predicting binary mortality.  Exact hidden sizes are not published; we use
(256, 64) hidden units, which reaches the paper's AUC operating regime on
the synthetic cohort.  [Shao et al., ML4H@NeurIPS 2019]
"""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="mlp-medical",
    family="mlp",
    source="Shao et al. 2019 (this paper), §2.2",
    mlp_features=(2917, 256, 64, 1),
    activation="relu",
    dtype="float32",
)
