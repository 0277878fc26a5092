from repro_torch.data.columnar import Table
from repro_torch.data import join, flightgen

__all__ = ["Table", "join", "flightgen"]
