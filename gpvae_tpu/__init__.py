"""gpvae_tpu — a Gaussian-Process VAE framework in JAX.

Brand-new implementation of the capabilities of the reference repo
ethanev/GP-VAE (a TF 1.x research codebase; see SURVEY.md): amortized
encoder/decoder networks with GP priors/posteriors over latent trajectories,
trained by a β-annealed ELBO, with irregular-time support, GP-posterior
imputation, and analysis tooling — re-architected around jit, batched
covariance ops with analytic custom VJPs, data-parallel sharding, and
mask-based static shapes.
"""
from gpvae_tpu import kernels, ops, gp

__version__ = "0.1.0"
