"""crd-puller — dump a cluster's API resources as CRD YAML files.

The analog of the reference's cmd/crd-puller/pull-crds.go:18-62: discover
the named resources on a cluster (existing CRDs or synthesized from
served types) and write one ``<plural>.<group>.yaml`` per resource.
"""

from __future__ import annotations

import logging
import sys

import yaml

from ..crdpuller import SchemaPuller
from ..server.rest import RestClient
from .help import parser

DOC = """Pull API resource schemas from a cluster and write them as
CustomResourceDefinition YAML files in the current directory."""


def build_parser():
    p = parser("crd-puller", DOC)
    p.add_argument("--server", required=True,
                   help="cluster URL (reference: -kubeconfig)")
    p.add_argument("--cluster", default="default")
    p.add_argument("--ca-file", default=None,
                   help="CA bundle for an https --server (e.g. the kcp "
                        "root dir's pki/ca.crt)")
    p.add_argument("--out-dir", default=".")
    p.add_argument("resources", nargs="+",
                   help="resources to pull, e.g. deployments.apps")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    client = RestClient(args.server, cluster=args.cluster,
                        ca_file=args.ca_file)
    puller = SchemaPuller(client)
    pulled = puller.pull_crds(args.resources)
    rc = 0
    for res, crd in pulled.items():
        if crd is None:
            print(f"{res}: not served by {args.server}", file=sys.stderr)
            rc = 1
            continue
        path = f"{args.out_dir}/{crd['metadata']['name']}.yaml"
        with open(path, "w", encoding="utf-8") as f:
            yaml.safe_dump(crd, f, sort_keys=False)
        print(path)
    return rc


if __name__ == "__main__":
    sys.exit(main())
