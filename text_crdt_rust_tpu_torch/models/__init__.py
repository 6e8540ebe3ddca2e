"""Host models of the port: the numpy oracle and its txn export."""
from .oracle import ClientData, ListCRDT

__all__ = ["ClientData", "ListCRDT"]
