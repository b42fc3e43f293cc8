"""Test-stream support of the port: the synthetic picture sources its
dry run and smoke script encode (the libavcodec oracle stays in the JAX
package's ``testing`` and only the tests use it)."""
