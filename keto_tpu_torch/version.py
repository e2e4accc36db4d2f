"""Framework version (a copy of keto_tpu/version.py).

The reference exposes its version over the gRPC VersionService
(reference proto/ory/keto/acl/v1alpha1/version.proto:15-19) and `keto version`;
the port's REST servers answer it on ``/version``.
"""

__version__ = "0.1.0"
