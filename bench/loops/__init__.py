"""One module a way of driving an entry point through a run, named by the
traffic file's ``loop``: ``run(spec, sess, ranks, device)`` runs set-up, the
measured window and, with ``--trace 1``, the traced extras, and returns the
rank's record (what the metric readers read) and the states it kept for
the check."""
