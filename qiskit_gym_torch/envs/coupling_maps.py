"""Coupling maps of published devices, as undirected edge lists (i < j) for
`BaseSynthesisEnv.from_coupling_map`.

`eagle_127q` is IBM's 127-qubit Eagle heavy-hex layout (ibm_washington,
ibm_sherbrooke, ibm_brisbane): seven rows of qubits, each a chain, joined
by bridge qubits of degree 2. It is the `coupling_map` of IBM's published
ibm_washington backend configuration, as qiskit-ibm-runtime ships it for
`FakeWashingtonV2` (`qiskit_ibm_runtime/fake_provider/backends/washington/
conf_washington.json`), taken undirected; ibm_sherbrooke's and
ibm_brisbane's (`backends/sherbrooke/conf_sherbrooke.json`,
`backends/brisbane/conf_brisbane.json`) have the same 144 couplers.
"""

from __future__ import annotations

from typing import List, Tuple

# (first qubit, length) of each row of the Eagle layout
EAGLE_ROWS = ((0, 14), (18, 15), (37, 15), (56, 15), (75, 15), (94, 15),
              (113, 14))
# where the bridges leave each row and reach the next: offsets within the
# row of the 1st of 4 bridges, then every 4th qubit
EAGLE_BRIDGE_OFFSETS = ((0, 0), (2, 2), (0, 0), (2, 2), (0, 0), (2, 1))


def eagle_127q() -> List[Tuple[int, int]]:
    """The 144 couplers of the 127-qubit Eagle heavy-hex layout, sorted.

    Rows 0-13, 18-32, 37-51, 56-70, 75-89, 94-108 and 113-126 are chains.
    Between two rows sit four bridge qubits (14-17, 33-36, 52-55, 71-74,
    90-93, 109-112), each joining a qubit of the row above to one of the
    row below: 14 joins 0 and 18, 15 joins 4 and 22, 33 joins 20 and 39,
    112 joins 108 and 126."""
    edges = []
    for first, length in EAGLE_ROWS:
        edges += [(q, q + 1) for q in range(first, first + length - 1)]
    for r, (up, down) in enumerate(EAGLE_BRIDGE_OFFSETS):
        top, length = EAGLE_ROWS[r]
        bottom = EAGLE_ROWS[r + 1][0]
        bridge = top + length
        for k in range(4):
            edges += [(top + up + 4 * k, bridge + k),
                      (bridge + k, bottom + down + 4 * k)]
    return sorted(edges)
