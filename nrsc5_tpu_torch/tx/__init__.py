"""Truth-harness transmitter: numpy copies of the reference package's FM
and AM encoders, modulators and channel helpers."""
