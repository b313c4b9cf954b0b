from .ngp import (NGPConfig, ngp_init, ngp_sigma_cm, ngp_grad_cm,
                  ngp_forward_cm, params_from_numpy, params_to_numpy)
from .rendering import RenderConfig, render_rays_test
