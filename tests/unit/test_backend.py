"""Device selection, the complex64 input boundary, the compile cache and
the CLI's refusal of removed options (utils/backend.py, ui/cli.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tetraear_tpu.utils import backend


class TestPlatform:
    def test_cpu_is_an_explicit_choice(self):
        # already on the CPU here: pinning it again is a no-op
        backend.apply_platform("cpu")
        assert jax.default_backend() == "cpu"

    def test_default_keeps_jax_choice(self, monkeypatch):
        calls = []
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        backend.apply_platform("default")
        assert calls == []

    @pytest.mark.parametrize("name", ["auto", "gpu", "bogus"])
    def test_unknown_platform_raises(self, name):
        with pytest.raises(ValueError):
            backend.apply_platform(name)


class TestComplexBoundary:
    @pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
    def test_host_round_trip(self, dtype):
        x = (np.arange(7) + 1j * np.arange(7, 0, -1)).astype(dtype)
        d = backend.ensure_complex_on_device(x)
        assert isinstance(d, jax.Array) and d.dtype == jnp.complex64
        np.testing.assert_array_equal(np.asarray(d), x.astype(np.complex64))

    def test_device_array_passes_through(self):
        d = jnp.asarray(np.ones(4, np.complex64))
        assert backend.ensure_complex_on_device(d) is d

    def test_tracer_passes_through(self):
        f = jax.jit(lambda a: backend.ensure_complex_on_device(a) * 2)
        out = f(jnp.ones(3, jnp.complex64))
        np.testing.assert_array_equal(np.asarray(out), 2 * np.ones(3))


class TestCompileCache:
    def test_env_var_is_honoured(self, monkeypatch, tmp_path):
        calls = []
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        assert backend.enable_compile_cache() == str(tmp_path)
        assert calls == []                 # nothing set in code

    def test_default_is_the_checkout(self, monkeypatch):
        calls = []
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        path = backend.enable_compile_cache()
        assert path == str(backend.CHECKOUT / ".jax_cache")
        assert ("jax_compilation_cache_dir", path) in calls
        assert (backend.CHECKOUT / "tetraear_tpu").is_dir()

    def test_path_is_stable(self, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(jax.config, "update", lambda *a: None)
        a = backend.enable_compile_cache()
        b = backend.enable_compile_cache()
        assert a == b
        import os
        import tempfile
        assert str(os.getpid()) not in a
        assert not a.startswith(tempfile.gettempdir())


class TestCli:
    @pytest.mark.parametrize("conv", ["pallas", "pallas_bf16"])
    def test_removed_conv_variants_refused(self, conv, tmp_path):
        from tetraear_tpu.ui.cli import main
        with pytest.raises(SystemExit) as e:
            main(["decode", str(tmp_path / "x.cf32"), "--carriers", "4",
                  "--conv", conv])
        assert e.value.code == 2

    @pytest.mark.parametrize("platform", ["auto", "bogus"])
    def test_removed_platforms_refused(self, platform):
        from tetraear_tpu.ui.cli import main
        with pytest.raises(SystemExit) as e:
            main(["--platform", platform, "devices"])
        assert e.value.code == 2

    def test_backend_error_propagates(self, monkeypatch, tmp_path):
        """A failure on the device is the user's error to see: no retry
        on another platform."""
        from tetraear_tpu.ui import cli

        monkeypatch.setenv("TETRAEAR_TPU_LOG_DIR", str(tmp_path))
        monkeypatch.setattr(backend, "enable_compile_cache", lambda: "")
        calls = []

        def boom(args):
            calls.append(args)
            raise RuntimeError("INTERNAL: device failure")

        monkeypatch.setattr(cli, "cmd_devices", boom)
        with pytest.raises(RuntimeError, match="INTERNAL"):
            cli.main(["devices"])
        assert len(calls) == 1

    @pytest.mark.parametrize("argv,platform", [
        (["devices"], "default"), (["--platform", "cpu", "devices"], "cpu")])
    def test_platform_flag(self, monkeypatch, tmp_path, argv, platform):
        from tetraear_tpu.ui import cli

        monkeypatch.setenv("TETRAEAR_TPU_LOG_DIR", str(tmp_path))
        monkeypatch.setattr(backend, "enable_compile_cache", lambda: "")
        seen = []
        monkeypatch.setattr(backend, "apply_platform", seen.append)
        monkeypatch.setattr(cli, "cmd_devices", lambda args: 0)
        assert cli.main(argv) == 0
        assert seen == [platform]
