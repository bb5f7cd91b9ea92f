from .sage import GraphSAGE, SAGEConv, masked_mean_aggregate

__all__ = ["GraphSAGE", "SAGEConv", "masked_mean_aggregate"]
