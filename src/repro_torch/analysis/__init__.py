"""The dry run's analysis: the analytic HBM traffic model
(``memtraffic``), the three-term roofline (``roofline``) and one pass of a
step under fake tensors (``fake_run``), the port's counterpart of the
compiled artifact the JAX package's dry run reads."""
