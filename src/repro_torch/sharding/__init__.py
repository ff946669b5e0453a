from .rules import (param_spec, params_shardings, cache_spec, cache_shardings,
                    batch_shardings, batch_axes, replicated)
