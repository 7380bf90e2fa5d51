"""Radio front-end sources: the rtl_tcp client."""
