"""Control-plane transport: stdlib HTTP in place of gRPC, with the retry policy."""
