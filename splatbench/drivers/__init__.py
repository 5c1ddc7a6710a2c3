"""Traffic drivers, one module a kind of client; a traffic file names its driver."""
