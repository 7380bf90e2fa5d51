"""Truth-harness transmitter: numpy copies of the reference package's FM
encoder, modulator and channel helpers."""
