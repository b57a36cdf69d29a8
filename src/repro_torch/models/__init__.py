"""The dense-family language model of the port: layers (``layers``), the
decoder stack (``model``) and parameters carried over from the JAX package
(``convert``)."""
