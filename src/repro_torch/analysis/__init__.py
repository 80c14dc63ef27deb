"""The dry run's analysis: the analytic HBM traffic model
(``memtraffic``), the three-term roofline (``roofline``) and one pass of a
step under fake tensors (``fake_run``), the port's counterpart of the
compiled artifact the JAX package's dry run reads; and the schedule
linter: one rank's issue-order log (``comm_log``), the rules over it
(``rules``), the programs it lints (``lint_targets``) and the CLI
(``schedule_lint``), the port's counterpart of the JAX package's HLO
linter."""
