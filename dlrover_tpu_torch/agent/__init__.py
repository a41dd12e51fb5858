"""The per-host elastic agent, its master client and rendezvous."""
