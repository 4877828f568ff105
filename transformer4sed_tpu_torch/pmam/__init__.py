"""PMAM's tokenizer and post-pretraining (port of ``pmam/``): frame-feature
taps, GMM / KMeans / PCA on the card, pseudo-label TSVs and the
prototype-BCE step."""

from transformer4sed_tpu_torch.pmam.features import extract_frame_features, sample_features
from transformer4sed_tpu_torch.pmam.gmm import PCA, GaussianMixture, KMeans
from transformer4sed_tpu_torch.pmam.pseudo_labels import frame_probs_to_tsv, generate_pseudo_labels
from transformer4sed_tpu_torch.pmam.train import (
    PMAMConfig,
    PMAMTrainer,
    masked_bce,
    prototype_predictions,
)

__all__ = [
    "GaussianMixture",
    "KMeans",
    "PCA",
    "extract_frame_features",
    "sample_features",
    "frame_probs_to_tsv",
    "generate_pseudo_labels",
    "PMAMConfig",
    "PMAMTrainer",
    "masked_bce",
    "prototype_predictions",
]
