"""Cluster membership, layout and quorum RPC (reference src/rpc/)."""
