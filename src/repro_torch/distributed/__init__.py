"""Distribution: the sharding rules, the collectives, expert-parallel MoE
and the train and serve step builders, on one device or on a
``torch.distributed`` mesh (``repro_torch.launch.mesh``)."""
from .moe_ep import ep_applicable, moe_apply_ep
from .sharding import (LayerPlan, batch_sharding, cache_shardings,
                       hidden_sharding, opt_shardings, param_shardings,
                       plans_for, spec_str)
from .stepfn import (make_serve_step, make_train_step, place_model,
                     prefill_step, serve_step, shardings_for_train)

__all__ = ["LayerPlan", "batch_sharding", "cache_shardings",
           "hidden_sharding", "opt_shardings", "param_shardings",
           "plans_for", "spec_str", "ep_applicable", "moe_apply_ep",
           "make_serve_step", "make_train_step", "place_model",
           "prefill_step", "serve_step", "shardings_for_train"]
