"""Clustering for PMAM's tokenizer on the card: GMM (EM), KMeans, PCA (port of
``pmam/gmm.py``).

The reference fits a pycave GaussianMixture (full covariance) or KMeans,
optionally after PCA, over the tapped frame embeddings
(``recipes/desed/pmam/gmm.py:40-79``). The three keep the JAX package's
algorithms, initialisations and outputs (``means``, ``covariances``,
``weights`` as numpy arrays; ``fit`` / ``predict_proba`` / ``transform``):

  * KMeans is seeded by numpy's ``default_rng(seed)`` exactly as the JAX
    class is, so both pick the same initial centroids; its k-means++ seeding
    keeps the running minimum of the squared distances instead of the JAX
    class's [n, k, D] difference of every step (the same values, one
    centroid's [n, D] difference at a time);
  * the M step accumulates the moments about the incoming means
    (:meth:`GaussianMixture.em_step`), equal in exact arithmetic and free of
    f32 cancellation;
  * the full-covariance log-density whitens each component once: with
    ``P_k = L_k^-1`` (``L_k`` the Cholesky factor of the covariance), the
    Mahalanobis term of a chunk is one batched GEMM of the [K, rows, D]
    differences by ``P_k^T``, where the JAX class runs a triangular solve on
    them. The rows a chunk takes follow from the card's free memory (a
    quarter of it for the three [K, rows, D] temporaries; 2**28 bytes on the
    CPU); chunking changes only the order of the f32 sums.

Precision: the statistics, the Cholesky factors and every product run in full
float32 (or the ``dtype`` asked for, float64 for a reference on the CPU), never
TF32 or bf16: :func:`full_precision` turns TF32 off for each call and restores
the global settings after, so the GMM does not inherit an ``allow_tf32`` set
elsewhere.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Union

import numpy as np
import torch

from transformer4sed_tpu_torch.utils.device import resolve_device

Array = Union[np.ndarray, torch.Tensor]


@contextlib.contextmanager
def full_precision():
    """Matmuls and convolutions in full float32 inside (TF32 off for cuBLAS and
    cuDNN); the global settings are restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def chunk_rows(device: torch.device, bytes_per_row: int) -> int:
    """Rows of a chunk whose temporaries take ``bytes_per_row`` each: a quarter
    of the card's free memory, or 2**28 bytes on the CPU."""
    budget = torch.cuda.mem_get_info(device)[0] // 4 if device.type == "cuda" else 2 ** 28
    return max(1, int(budget // max(bytes_per_row, 1)))


def _chunks(x: torch.Tensor, rows: int, device: torch.device, dtype: torch.dtype):
    for i in range(0, x.shape[0], rows):
        yield x[i:i + rows].to(device=device, dtype=dtype)


def _as_tensor(data: Array) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data
    a = np.asarray(data)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


class PCA:
    """Eigendecomposition PCA (sklearn-equivalent transform): the mean in
    float64 on the host, the covariance's products in float32 on the device
    (as the JAX class's, whose products run in JAX's default float32), the
    eigendecomposition in float64 on the host."""

    def __init__(self, n_components: int, device=None):
        self.n_components = n_components
        self.device = resolve_device(device)
        self.mean_: Optional[np.ndarray] = None
        self.components_: Optional[np.ndarray] = None

    def fit(self, data: np.ndarray, batch_size: int = 1_000_000) -> "PCA":
        data = np.asarray(data)
        total, d = data.shape
        mean = np.zeros(d, np.float64)
        for i in range(0, total, batch_size):
            mean += np.asarray(data[i:i + batch_size], np.float64).sum(0)
        mean /= total
        cov = np.zeros((d, d), np.float64)
        with full_precision():
            for i in range(0, total, batch_size):
                c = torch.from_numpy(np.asarray(data[i:i + batch_size], np.float64) - mean)
                c = c.to(device=self.device, dtype=torch.float32)
                cov += (c.T @ c).double().cpu().numpy()
        cov /= max(total - 1, 1)
        eigvals, eigvecs = np.linalg.eigh(cov)
        order = np.argsort(eigvals)[::-1][: self.n_components]
        self.mean_ = mean.astype(np.float32)
        self.components_ = eigvecs[:, order].T.astype(np.float32)  # [k, d]
        return self

    def transform(self, data: np.ndarray) -> np.ndarray:
        return (np.asarray(data) - self.mean_) @ self.components_.T

    def fit_transform(self, data: np.ndarray) -> np.ndarray:
        return self.fit(data).transform(data)


class KMeans:
    def __init__(self, num_clusters: int, n_iter: int = 50, seed: int = 0, device=None):
        self.num_clusters = num_clusters
        self.n_iter = n_iter
        self.seed = seed
        self.device = resolve_device(device)
        self.centroids: Optional[np.ndarray] = None

    def _init_centroids(self, data: np.ndarray) -> np.ndarray:
        """k-means++ seeding on a subsample, numpy's generator making every
        choice as in the JAX class; the squared distances in float32 on the
        device."""
        rng = np.random.default_rng(self.seed)
        sub = data[rng.choice(len(data), size=min(len(data), 100_000), replace=False)]
        centroids = [sub[rng.integers(len(sub))]]
        sub_t = torch.from_numpy(np.ascontiguousarray(sub, np.float32)).to(self.device)
        d2 = None
        for _ in range(self.num_clusters - 1):
            c = torch.from_numpy(np.asarray(centroids[-1], np.float32)).to(self.device)
            new = torch.sum((sub_t - c[None]) ** 2, -1)
            d2 = new if d2 is None else torch.minimum(d2, new)
            d2_np = d2.cpu().numpy()
            probs = d2_np / d2_np.sum()
            centroids.append(sub[rng.choice(len(sub), p=probs)])
        return np.stack(centroids).astype(np.float32)

    def fit(self, data: np.ndarray, batch_size: int = 1_000_000) -> "KMeans":
        data = np.asarray(data)
        with full_precision():
            cents = torch.from_numpy(self._init_centroids(data)).to(self.device)
            x = _as_tensor(np.asarray(data, np.float32))
            for _ in range(self.n_iter):
                sums = torch.zeros_like(cents)
                counts = torch.zeros(self.num_clusters, device=self.device)
                for chunk in _chunks(x, batch_size, self.device, torch.float32):
                    idx = self._assign(chunk, cents)
                    one_hot = torch.nn.functional.one_hot(idx, self.num_clusters).to(chunk.dtype)
                    sums += one_hot.T @ chunk
                    counts += one_hot.sum(0)
                cents = torch.where(counts[:, None] > 0,
                                    sums / torch.clamp(counts[:, None], min=1), cents)
        self.centroids = cents.cpu().numpy()
        return self

    @staticmethod
    def _assign(chunk: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
        d2 = ((chunk ** 2).sum(1, keepdim=True) - 2 * chunk @ cents.T
              + (cents ** 2).sum(1)[None])
        return torch.argmin(d2, dim=1)

    @property
    def means(self) -> np.ndarray:
        return self.centroids

    def predict(self, data: np.ndarray) -> np.ndarray:
        with full_precision():
            x = torch.from_numpy(np.asarray(data, np.float32)).to(self.device)
            cents = torch.from_numpy(self.centroids).to(self.device)
            return self._assign(x, cents).cpu().numpy()


class GaussianMixture:
    """EM Gaussian mixture with 'full' or 'diag' covariance, on ``device``
    in ``dtype``. ``log_likelihoods`` holds, after :meth:`fit`, the mean
    log-likelihood of the data under the parameters each EM iteration
    started from."""

    def __init__(self, num_components: int, covariance_type: str = "full", n_iter: int = 50,
                 reg_covar: float = 1e-6, seed: int = 0, kmeans_init: bool = True, device=None,
                 dtype: torch.dtype = torch.float32):
        if covariance_type not in ("full", "diag"):
            raise ValueError(f"unknown covariance type {covariance_type!r}")
        self.k = num_components
        self.covariance_type = covariance_type
        self.n_iter = n_iter
        self.reg_covar = reg_covar
        self.seed = seed
        self.kmeans_init = kmeans_init
        self.device = resolve_device(device)
        self.dtype = dtype
        self.means: Optional[np.ndarray] = None
        self.covariances: Optional[np.ndarray] = None
        self.weights: Optional[np.ndarray] = None
        self.log_likelihoods: List[float] = []
        self.rows_per_chunk: Optional[int] = None

    # -- the densities and the EM step on tensors -------------------------------------
    def _t(self, a: Array) -> torch.Tensor:
        return _as_tensor(a).to(device=self.device, dtype=self.dtype)

    def _rows(self, d: int) -> int:
        """Rows of a chunk: three [K, rows, D] temporaries."""
        return chunk_rows(self.device, 3 * self.k * d * torch.finfo(self.dtype).bits // 8)

    def _factors(self, covs: torch.Tensor):
        """(whitening factors, log-determinants): ``L_k^-1`` for a full
        covariance (L_k its Cholesky factor), ``1 / var`` for a diagonal one."""
        if self.covariance_type == "diag":
            return 1.0 / covs, torch.log(covs).sum(-1)
        chol = torch.linalg.cholesky(covs)  # [K, D, D]
        eye = torch.eye(covs.shape[-1], device=covs.device, dtype=covs.dtype)
        prec = torch.linalg.solve_triangular(chol, eye.expand_as(chol), upper=False)
        logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=1, dim2=2)).sum(-1)
        return prec, logdet

    def _log_prob(self, x: torch.Tensor, means, factors, logdet, log_w):
        """([rows, K] log(w_k N(x | mu_k, Sigma_k)), the [K, rows, D] differences
        x - mu_k)."""
        d = x.shape[-1]
        diff = x[None] - means[:, None]  # [K, rows, D]
        if self.covariance_type == "diag":
            maha = (diff * diff * factors[:, None]).sum(-1)
        else:
            maha = (torch.bmm(diff, factors.transpose(1, 2)) ** 2).sum(-1)  # P_k (x - mu_k)
        return log_w[None] - 0.5 * (maha.T + logdet[None] + d * math.log(2 * math.pi)), diff

    def em_step(self, data: Array, means: Array, covs: Array, weights: Array):
        """One EM iteration from the given state: (means, covariances,
        weights, mean log-likelihood under the given state), tensors on the
        mixture's device in its dtype. The M step is the JAX class's, with
        the first and second moments accumulated about the incoming means
        mu_k (the differences the E step has formed): mu'_k = mu_k + S1_k / n_k
        and Sigma'_k = S2_k / n_k - (mu'_k - mu_k)(mu'_k - mu_k)^T + reg I equal
        its E[x x^T] - mu' mu'^T in exact arithmetic, without the f32
        cancellation of frames whose mean is far from 0."""
        with full_precision():
            x = _as_tensor(data)
            means, covs, weights = self._t(means), self._t(covs), self._t(weights)
            n, d = x.shape
            rows = self._rows(d)
            self.rows_per_chunk = rows
            factors, logdet = self._factors(covs)
            log_w = torch.log(weights)
            nk = torch.zeros(self.k, device=self.device, dtype=self.dtype)
            mean_stat = torch.zeros(self.k, d, device=self.device, dtype=self.dtype)
            cov_stat = torch.zeros(covs.shape, device=self.device, dtype=self.dtype)
            loglik = torch.zeros((), device=self.device, dtype=self.dtype)
            for chunk in _chunks(x, rows, self.device, self.dtype):
                lp, diff = self._log_prob(chunk, means, factors, logdet, log_w)
                log_norm = torch.logsumexp(lp, dim=1, keepdim=True)
                resp = torch.exp(lp - log_norm).T[:, :, None]  # [K, rows, 1]
                nk += resp.sum((1, 2))
                weighted = resp * diff  # r_nk (x_n - mu_k)
                mean_stat += weighted.sum(1)
                if self.covariance_type == "diag":
                    cov_stat += (weighted * diff).sum(1)
                else:
                    cov_stat += torch.bmm(weighted.transpose(1, 2), diff)
                loglik += log_norm.sum()
            nk = torch.clamp(nk, min=1e-6)
            shift = mean_stat / nk[:, None]  # mu'_k - mu_k
            if self.covariance_type == "diag":
                new_covs = torch.clamp(cov_stat / nk[:, None] - shift ** 2 + self.reg_covar,
                                       min=self.reg_covar)
            else:
                new_covs = (cov_stat / nk[:, None, None] - shift[:, :, None] * shift[:, None, :]
                            + self.reg_covar * torch.eye(d, device=self.device,
                                                         dtype=self.dtype)[None])
            return means + shift, new_covs, nk / nk.sum(), loglik / n

    def initial_state(self, data: np.ndarray):
        """The JAX class's starting point: KMeans centroids (10 iterations on
        a seeded subsample) or seeded rows as means, every covariance the
        data's variance plus ``reg_covar`` (diagonal), equal weights."""
        data = np.asarray(data, np.float32)
        n, _ = data.shape
        if self.kmeans_init:
            sub = np.random.default_rng(self.seed).choice(n, size=min(n, 200_000), replace=False)
            means = KMeans(self.k, n_iter=10, seed=self.seed, device=self.device).fit(
                data[sub]).centroids
        else:
            rng = np.random.default_rng(self.seed)
            means = data[rng.choice(n, size=self.k, replace=False)]
        var0 = np.var(data[: min(n, 100_000)], axis=0) + self.reg_covar
        covs = (np.tile(var0[None], (self.k, 1)) if self.covariance_type == "diag"
                else np.tile(np.diag(var0)[None], (self.k, 1, 1)))
        return means, covs, np.full((self.k,), 1.0 / self.k, np.float32)

    def fit(self, data: np.ndarray) -> "GaussianMixture":
        """EM from :meth:`initial_state` for ``n_iter`` iterations. The data
        go to the card once when they take under a quarter of its free
        memory, else chunk by chunk each iteration."""
        data = np.asarray(data, np.float32)
        means, covs, weights = (self._t(a) for a in self.initial_state(data))
        x = torch.from_numpy(data)
        on_card = self.device.type == "cuda"
        if on_card and data.nbytes < torch.cuda.mem_get_info(self.device)[0] // 4:
            x = x.to(self.device)
        self.log_likelihoods = []
        for _ in range(self.n_iter):
            means, covs, weights, loglik = self.em_step(x, means, covs, weights)
            self.log_likelihoods.append(float(loglik))
        self.means = means.float().cpu().numpy()
        self.covariances = covs.float().cpu().numpy()
        self.weights = weights.float().cpu().numpy()
        return self

    def predict_proba(self, data: Array) -> Array:
        """[N, K] posteriors; a tensor in gives a tensor (on the mixture's
        device), numpy in gives numpy."""
        with full_precision():
            x = _as_tensor(data)
            factors, logdet = self._factors(self._t(self.covariances))
            means, log_w = self._t(self.means), torch.log(self._t(self.weights))
            rows = self._rows(x.shape[-1])
            out = torch.cat([torch.softmax(self._log_prob(c, means, factors, logdet, log_w)[0], 1)
                             for c in _chunks(x, rows, self.device, self.dtype)])
        return out if isinstance(data, torch.Tensor) else out.cpu().numpy()

    def predict(self, data: np.ndarray) -> np.ndarray:
        return np.asarray(self.predict_proba(np.asarray(data))).argmax(axis=1)
