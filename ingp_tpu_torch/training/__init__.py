from .trainer import (NeRFSystem, model_config_from_hparams,
                      render_config_from_hparams)
