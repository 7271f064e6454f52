"""Traffic kinds: the general generators that read a mix's parameters."""
