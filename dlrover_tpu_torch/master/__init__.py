"""The job master: servicer, rendezvous, node management (standalone)."""
