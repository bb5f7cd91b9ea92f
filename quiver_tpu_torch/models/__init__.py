from .gat import GAT, GATConv
from .gcn import GCN, GCNConv
from .sage import GraphSAGE, SAGEConv, masked_mean_aggregate

__all__ = ["GAT", "GATConv", "GCN", "GCNConv", "GraphSAGE", "SAGEConv",
           "masked_mean_aggregate"]
