"""Scale-out over several devices, or several shards of one card: row
tiles of one huge frame (``spatial``) and the data x templ mesh for
matching, training and the production tier (``mesh``)."""
