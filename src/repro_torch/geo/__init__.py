from .matern import matern_covariance, generate_locations
from .likelihood import gaussian_loglik, loglik_terms_from_factor
from .kl import kl_divergence_mxp

__all__ = [
    "matern_covariance", "generate_locations",
    "gaussian_loglik", "loglik_terms_from_factor",
    "kl_divergence_mxp",
]
