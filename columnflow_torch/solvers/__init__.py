from columnflow_torch.solvers.sde import brownian_pack, sdeint

__all__ = ["brownian_pack", "sdeint"]
