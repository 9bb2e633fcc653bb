"""Self-signed serving certificates for the control plane.

The reference generates an ECDSA CA + client/server certs at startup for
its embedded etcd and serves the API over TLS :6443
(/root/reference/pkg/etcd/etcd.go:98-188 generateClientAndServerCerts;
pkg/server/server.go:151-176 writes a kubeconfig against the secure
endpoint). This module is the kcp-tpu equivalent: an ECDSA P-521 CA
(curve parity with the reference) signing a server certificate with
SANs for the serving hosts, persisted under the server's root dir so
restarts keep the same CA, plus ssl.SSLContext builders for both ends.

Everything uses the ``cryptography`` package — no shelling out.
"""

from __future__ import annotations

import datetime
import ipaddress
import os
import ssl
import tempfile

CA_NAME = "kcp-tpu-ca"
_ONE_DAY = datetime.timedelta(days=1)
_TEN_YEARS = datetime.timedelta(days=3650)


def _new_key():
    from cryptography.hazmat.primitives.asymmetric import ec

    # P-521: the reference's curve (etcd.go:118 elliptic.P521())
    return ec.generate_private_key(ec.SECP521R1())


def _key_pem(key) -> bytes:
    from cryptography.hazmat.primitives import serialization

    return key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    )


def generate_ca(common_name: str = CA_NAME) -> tuple[bytes, bytes]:
    """(cert_pem, key_pem) for a self-signed CA."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.x509.oid import NameOID

    key = _new_key()
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - _ONE_DAY)
        .not_valid_after(now + _TEN_YEARS)
        .add_extension(x509.BasicConstraints(ca=True, path_length=0), critical=True)
        .add_extension(
            x509.KeyUsage(digital_signature=True, key_cert_sign=True,
                          crl_sign=True, content_commitment=False,
                          key_encipherment=False, data_encipherment=False,
                          key_agreement=False, encipher_only=False,
                          decipher_only=False),
            critical=True,
        )
        .sign(key, hashes.SHA256())
    )
    return cert.public_bytes(serialization.Encoding.PEM), _key_pem(key)


def generate_server_cert(
    ca_cert_pem: bytes, ca_key_pem: bytes, hosts: list[str],
    common_name: str = "kcp-tpu",
) -> tuple[bytes, bytes]:
    """(cert_pem, key_pem) for a server certificate signed by the CA,
    with DNS/IP SANs for every entry in ``hosts``."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.x509.oid import ExtendedKeyUsageOID, NameOID

    ca_cert = x509.load_pem_x509_certificate(ca_cert_pem)
    ca_key = serialization.load_pem_private_key(ca_key_pem, password=None)
    key = _new_key()
    sans = []
    for h in hosts:
        try:
            sans.append(x509.IPAddress(ipaddress.ip_address(h)))
        except ValueError:
            sans.append(x509.DNSName(h))
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(x509.Name([x509.NameAttribute(NameOID.COMMON_NAME,
                                                    common_name)]))
        .issuer_name(ca_cert.subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - _ONE_DAY)
        .not_valid_after(now + _TEN_YEARS)
        .add_extension(x509.SubjectAlternativeName(sans), critical=False)
        .add_extension(x509.BasicConstraints(ca=False, path_length=None),
                       critical=True)
        .add_extension(
            x509.ExtendedKeyUsage([ExtendedKeyUsageOID.SERVER_AUTH]),
            critical=False,
        )
        .sign(ca_key, hashes.SHA256())
    )
    return cert.public_bytes(serialization.Encoding.PEM), _key_pem(key)


class ServingCerts:
    """The server's TLS material: CA + server cert/key on disk.

    ``load_or_create(dir)`` reuses an existing CA across restarts (the
    kubeconfig users hold its cert); with ``dir=None`` an ephemeral
    tempdir is used (in-memory servers).
    """

    def __init__(self, directory: str, ca_cert: bytes, server_cert: bytes,
                 server_key: bytes, _tmp=None):
        self.directory = directory
        self.ca_cert_pem = ca_cert
        self.server_cert_pem = server_cert
        self.server_key_pem = server_key
        self.server_cert_path = os.path.join(directory, "server.crt")
        self.server_key_path = os.path.join(directory, "server.key")
        self.ca_path = os.path.join(directory, "ca.crt")
        self._tmp = _tmp  # keeps an ephemeral tempdir alive
        # the object IS the material: writing happens here so a directly
        # constructed instance and load_or_create agree with the disk
        with open(self.server_cert_path, "wb") as f:
            f.write(server_cert)
        self._write_private(self.server_key_path, server_key)

    _ephemeral: dict[tuple, "ServingCerts"] = {}

    @classmethod
    def load_or_create(cls, directory: str | None,
                       hosts: list[str] | None = None) -> "ServingCerts":
        hosts = hosts or ["127.0.0.1", "localhost"]
        tmp = None
        if directory is None:
            # in-memory servers: one ephemeral CA per process per host
            # set — P-521 keygen is expensive and the material is
            # process-private anyway
            cached = cls._ephemeral.get(tuple(sorted(hosts)))
            if cached is not None:
                return cached
            tmp = tempfile.TemporaryDirectory(prefix="kcp-tpu-certs-")
            directory = tmp.name
        os.makedirs(directory, exist_ok=True)
        ca_crt = os.path.join(directory, "ca.crt")
        ca_key = os.path.join(directory, "ca.key")
        have_crt, have_key = os.path.exists(ca_crt), os.path.exists(ca_key)
        if have_crt != have_key:
            # a half-present CA pair must not silently mint a NEW CA —
            # that would invalidate every issued kubeconfig with no hint
            raise RuntimeError(
                f"CA material in {directory} is incomplete "
                f"(ca.crt {'present' if have_crt else 'missing'}, "
                f"ca.key {'present' if have_key else 'missing'}); restore "
                f"both or remove both to mint a fresh CA")
        if have_crt:
            with open(ca_crt, "rb") as f:
                ca_cert_pem = f.read()
            with open(ca_key, "rb") as f:
                ca_key_pem = f.read()
        else:
            ca_cert_pem, ca_key_pem = generate_ca()
            cls._write_private(ca_key, ca_key_pem)
            with open(ca_crt, "wb") as f:
                f.write(ca_cert_pem)
        cert_pem, key_pem = generate_server_cert(ca_cert_pem, ca_key_pem, hosts)
        sc = cls(directory, ca_cert_pem, cert_pem, key_pem, _tmp=tmp)
        if tmp is not None:
            cls._ephemeral[tuple(sorted(hosts))] = sc
        return sc

    @staticmethod
    def _write_private(path: str, data: bytes) -> None:
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "wb") as f:
            f.write(data)

    def server_context(self) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.server_cert_path, self.server_key_path)
        return ctx


def client_context(ca_pem: bytes | str | None = None,
                   ca_file: str | None = None) -> ssl.SSLContext:
    """A verifying client context trusting the given CA (PEM bytes/str or
    file path)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.verify_mode = ssl.CERT_REQUIRED
    ctx.check_hostname = True
    if ca_pem is not None:
        if isinstance(ca_pem, bytes):
            ca_pem = ca_pem.decode("ascii")
        ctx.load_verify_locations(cadata=ca_pem)
    elif ca_file is not None:
        ctx.load_verify_locations(cafile=ca_file)
    else:
        ctx.load_default_certs()
    return ctx
